"""The full post-processing chain: raw events → final key, in PyTorch.

Counterpart of ``qtpu/chain.py``: chopper/chopper2 epoch framing → pfind
offset acquisition → costream coincidence sifting (+ type-4 index to the
source side) → splicer → the EC pipeline (QBER → LDPC → verification → PA),
as two session objects exchanging typed messages over one link.  Each
chain takes a ``device``: sifting and its EC session run there.  Over an
in-process DirectLink the sift index and the sifted bits stay on the device
(a padded index row and Bob's compacted bits, each with a valid-prefix
count); over a wire link the index crosses as host integers.

Layout per sift window (one simulation window, <= 67 ms of wall-clock time so
device times fit the int32 contract — SURVEY.md framing notes):

    AliceChain                              BobChain
    ──────────                              ────────
    detector events (simulated)             detector events (simulated)
    TimingBasis(times, basis)  ──────────►  [first window: pfind offset]
                                            coincidence match + drift servo
                               ◄──────────  SiftIndex(matched alice events)
    splice → sifted bits → EC session       sifted bits → EC session
    ... EC protocol (qtpu.pipeline) continues on the same link ...

Spans (``qtpu_torch.tracing``): each party's framing of a call is a
``chain.push_stream``; Bob's batched sifting a ``sift.batch`` (children
``sift.pad``, ``sift.upload``, ``sift.match``, ``sift.outputs``,
``sift.fetch``; window: the batch's frame ids), a single frame a
``sift.one`` (``sift.pfind`` inside it at the cold start); Alice's handling
of a SiftIndex a ``chain.on_sift_index`` around its ``alice.splice``.
Each party's EC intake (``push_sifted``) runs outside them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from qtpu_torch import sift, tracing
from qtpu_torch.channel import EntangledPairSource, PairEvents
from qtpu_torch.devices import DEFAULT_DEVICE, resolve_device
from qtpu_torch.framing import TIME_UNITS_PER_NS
from qtpu_torch.link import make_direct_pair, make_loopback_pair
from qtpu_torch.messages import Message, SiftIndex, TimingBasis
from qtpu_torch.pipeline import AliceSession, BobSession, PipelineConfig

__all__ = ["ChainConfig", "AliceChain", "BobChain", "run_chain_loopback"]


@dataclasses.dataclass(frozen=True)
class ChainConfig:
    pipeline: PipelineConfig = dataclasses.field(default_factory=PipelineConfig)
    coincidence_window: int = 40        # 125 ps units (5 ns)
    pfind_bins: int = 1 << 18
    window_s: float = 0.05              # sift window length (must fit int32 span)
    servo_gain: float = 0.5
    # Batched sifting: match this many frames per batch with the drift
    # servo carried on the device between frames (sift.make_frame_matcher)
    # — one host fetch per batch instead of one per frame.  Set 1 for
    # per-frame sifting (low-latency mode, also used for the cold-start
    # pfind frame).
    sift_batch_frames: int = 8


class AliceChain:
    """Source side: sends timing+basis, splices her key at Bob's index.

    Frame ids are epoch-derived and can legitimately REPEAT (a simulation
    window spanning a frame boundary yields two partial chunks of the same
    frame), so per-frame state is FIFO-queued per id: the link is ordered
    and Bob answers chunks in processing order, so first-in pairs with
    first-answered."""

    def __init__(self, config: ChainConfig, session_seed: int, link,
                 device=DEFAULT_DEVICE):
        import collections
        self.config = config
        self.link = link
        self.ec = AliceSession(config.pipeline, session_seed, link,
                               device=device)
        self._window_bits: dict[int, "collections.deque"] = {}
        self._sift_window = 0

    def push_stream(self, times_abs: np.ndarray,
                    detectors: np.ndarray) -> None:
        """Epoch-true streaming (the chopper role, SURVEY.md §3 #3): split a
        continuous absolute-time event stream into device frames; every sift
        artifact is addressed by the real frame id (epoch id = frame >> 3)."""
        from qtpu_torch.framing import split_epochs
        with tracing.span("chain.push_stream"):
            for fid, t, d in split_epochs(times_abs, detectors):
                self._push_window(fid, t, d)

    def push_events(self, times_i32: np.ndarray, detectors: np.ndarray) -> None:
        """One sift window of local detector events (already rebased) —
        fixed-cadence API for simulation-window-per-call callers."""
        w = self._sift_window
        self._sift_window += 1
        self._push_window(w, times_i32, detectors)

    def _push_window(self, w: int, times_i32: np.ndarray,
                     detectors: np.ndarray) -> None:
        import collections
        basis = (detectors >> 1) & 1
        bits = detectors & 1
        self._window_bits.setdefault(
            w, collections.deque()).append(bits.astype(np.uint8))
        self.link.send(TimingBasis(window_id=w, times=times_i32,
                                   basis=basis.astype(np.uint8)))

    def pump(self) -> bool:
        msg = self.link.recv()
        if msg is None:
            return False
        self._dispatch(msg)
        return True

    def _dispatch(self, msg: Message) -> None:
        if isinstance(msg, SiftIndex):
            # The splice under a chain span; the EC's intake after it, a
            # top-level push_sifted as in every session.
            with tracing.span("chain.on_sift_index", msg.window_id):
                q = self._window_bits[msg.window_id]
                bits = q.popleft()
                if not q:
                    del self._window_bits[msg.window_id]
                if msg.count >= 0:
                    # Device-resident form: padded index row + valid
                    # prefix.  Splice as a device gather and append the
                    # padded result with the prefix length — no index/mask
                    # d2h anywhere on the sift path.
                    with tracing.span("alice.splice"):
                        sifted = self._splice_device(bits, msg.indices)
                    n = msg.count
                else:
                    sifted = np.asarray(bits, np.uint8)[
                        np.asarray(msg.indices, np.int64)]
                    n = None
            self.ec.push_sifted(sifted, n=n)
        else:
            self.ec.on_message(msg)
        if self.ec.can_start_window():
            self.ec.start_window()

    def _splice_device(self, bits: np.ndarray, idx_dev: torch.Tensor):
        """The raw key gathered at the peer's padded index row on its
        device.  The row is a permutation of the peer's padded capacity, so
        entries past the valid prefix may point beyond this frame's events:
        they are clamped into range (their bits are never used)."""
        raw = torch.from_numpy(np.array(bits, np.uint8)).to(idx_dev.device)
        if raw.numel() == 0:
            return torch.zeros(idx_dev.shape, dtype=torch.uint8,
                               device=idx_dev.device)
        return sift.splice(raw, idx_dev.clamp(max=raw.numel() - 1))

    def idle(self) -> bool:
        """True when nothing more can happen without new events or peer input."""
        return (not self._window_bits and not self.ec._inflight
                and not self.ec.can_start_window())


class BobChain:
    """Receiver side: acquires offset, coincidence-matches, emits SiftIndex."""

    # Frames of our own events held for a peer that announces none (~4.3 s
    # of stream at the 2^29-unit frame).
    HELD_FRAMES = 64

    def __init__(self, config: ChainConfig, session_seed: int, link,
                 device=DEFAULT_DEVICE):
        self.config = config
        self.link = link
        self.device = resolve_device(device)
        self.ec = BobSession(config.pipeline, session_seed, link,
                             device=device)
        self._events: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._pending_timing: dict[int, TimingBasis] = {}
        # The newest frame the peer has announced: she announces in frame
        # order, so frames below it that we still hold she never will.
        self._announced = -1
        self._sift_window = 0
        self.offset: Optional[int] = None
        # Per-frame sifting diagnostics (the reference getrate role,
        # SURVEY.md §3 #9): coincidence/accidental counts, basis-match and
        # sift ratios, servo residual.
        self.sift_stats: list[dict] = []
        # Batched sifting state: frames ready for the next batch
        # [(TimingBasis, times_b, det_b)].
        self._ready_frames: list[tuple] = []

    def push_stream(self, times_abs: np.ndarray,
                    detectors: np.ndarray) -> None:
        """Epoch-true streaming (the chopper2 role): frames by real ids."""
        from qtpu_torch.framing import split_epochs
        top = None
        with tracing.span("chain.push_stream"):
            for fid, t, d in split_epochs(times_abs, detectors):
                self._push_window(fid, t, d)
                top = fid
        if top is None:
            return
        # Sift ready frames the stream has MOVED PAST (no more chunks can
        # arrive for them) even when fewer than sift_batch_frames are
        # queued: batching must bound latency by stream progress, not
        # stall short streams behind a count threshold.
        old = [f for f in self._ready_frames if f[0].window_id < top]
        if old:
            self._ready_frames = [f for f in self._ready_frames
                                  if f[0].window_id >= top]
            if len(old) > 1:
                self._sift_batch(old)
            else:
                self._sift_one(*old[0])
        # Frames the peer announced but we never detected events in (and the
        # stream has moved past): reply with an empty sift index so her raw
        # key there is dropped symmetrically.
        for w in [w for w in self._pending_timing if w < top]:
            for _ in self._pending_timing.pop(w):
                self.link.send(SiftIndex(window_id=w,
                                         indices=np.zeros(0, np.int32)))
        # And frames we detected but the peer never announces: those below
        # her newest announcement, and any HELD_FRAMES behind the stream (a
        # bound for a silent peer).  Frames she is still to announce stay
        # however far the stream runs ahead of her announcements: dropping
        # them would answer her chunks empty and lose their key on both
        # sides.
        for w in [w for w in self._events
                  if w < self._announced or w < top - self.HELD_FRAMES]:
            self._events.pop(w)

    def push_events(self, times_i32: np.ndarray, detectors: np.ndarray) -> None:
        w = self._sift_window
        self._sift_window += 1
        self._push_window(w, times_i32, detectors)

    def _push_window(self, w: int, times_i32: np.ndarray,
                     detectors: np.ndarray) -> None:
        import collections
        self._events.setdefault(w, collections.deque()).append(
            (np.asarray(times_i32, np.int32),
             np.asarray(detectors, np.uint8)))
        # The peer's timing info may have raced ahead of local acquisition
        # (two-process mode); process it now that our events exist.
        pend = self._pending_timing.get(w)
        if pend:
            msg = pend.popleft()
            if not pend:
                del self._pending_timing[w]
            self._on_timing(msg)

    def pump(self) -> bool:
        msg = self.link.recv()
        if msg is None:
            # Link drained: resolve any deferred decodes (their acks unblock
            # Alice's next windows).
            return self.ec.flush()
        self._dispatch(msg)
        return True

    def _dispatch(self, msg: Message) -> None:
        if isinstance(msg, TimingBasis):
            self._on_timing(msg)
        else:
            self.ec.on_message(msg)

    def idle(self) -> bool:
        self.flush_sift()
        self.ec.flush()
        return not self._pending_timing and not self.ec._inflight

    def _on_timing(self, msg: TimingBasis) -> None:
        import collections
        self._announced = max(self._announced, msg.window_id)
        q = self._events.get(msg.window_id)
        if not q:
            self._pending_timing.setdefault(
                msg.window_id, collections.deque()).append(msg)
            return
        times_b, det_b = q.popleft()
        if not q:
            del self._events[msg.window_id]
        if self.offset is None or self.config.sift_batch_frames <= 1:
            # Cold start (pfind needs a frame NOW) / low-latency mode.
            self._sift_one(msg, times_b, det_b)
            return
        self._ready_frames.append((msg, times_b, det_b))
        if len(self._ready_frames) >= self.config.sift_batch_frames:
            self._sift_batch(self._ready_frames)
            self._ready_frames = []

    def flush_sift(self) -> None:
        """Sift any partial batch now (end of stream / drain)."""
        frames, self._ready_frames = self._ready_frames, []
        for msg, times_b, det_b in frames:
            self._sift_one(msg, times_b, det_b)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _sift_one(self, msg: TimingBasis, times_b: np.ndarray,
                  det_b: np.ndarray) -> None:
        with tracing.span("sift.one", msg.window_id):
            basis_b = (det_b >> 1) & 1
            bits_b = det_b & 1
            # Pad to the sticky power-of-two capacities (shared with the
            # batched path): padding at DEVICE_PAD never matches.
            na = len(msg.times)
            nb = len(times_b)
            self._na_cap = max(getattr(self, "_na_cap", 256), self._pow2(na))
            self._nb_cap = max(getattr(self, "_nb_cap", 256), self._pow2(nb))
            ta_p = np.full(self._na_cap, sift.DEVICE_PAD, np.int32)
            ta_p[:na] = msg.times
            ba_p = np.zeros(self._na_cap, np.uint8)
            ba_p[:na] = msg.basis
            tb_p = np.full(self._nb_cap, sift.DEVICE_PAD, np.int32)
            tb_p[:nb] = times_b
            bb_p = np.zeros(self._nb_cap, np.uint8)
            bb_p[:nb] = basis_b
            xb_p = np.zeros(self._nb_cap, np.uint8)
            xb_p[:nb] = bits_b
            ta = self._to_dev(ta_p)
            tb = self._to_dev(tb_p)
            if self.offset is None:
                span = min(int(self.config.window_s * 1e9
                               * TIME_UNITS_PER_NS), sift.MAX_SPAN)
                with tracing.span("sift.pfind"):
                    self.offset = int(sift.pfind(
                        *self._pfind_times(ta, tb, msg.times, times_b, span),
                        span, num_bins=self.config.pfind_bins))
            r = sift.coincidence_match(
                ta, self._to_dev(ba_p), tb, self._to_dev(bb_p),
                self._to_dev(xb_p),
                torch.tensor(self.offset, dtype=torch.int32,
                             device=self.device),
                self.config.coincidence_window)
            # Drift servo: track the residual for the next window.
            residual = float(r.residual)
            self.offset += int(self.config.servo_gain * residual)
            matched = r.matched.cpu().numpy()
            sifted_mask = matched & r.basis_ok.cpu().numpy()
            idx = np.flatnonzero(sifted_mask).astype(np.int32)
            bob_bits = r.bob_bits.cpu().numpy()[idx]
        # The EC's intake outside the sift span (a top-level push_sifted,
        # as in every session), then the index, in the order the protocol
        # has always sent them.
        self.ec.push_sifted(bob_bits.astype(np.uint8))
        self.link.send(SiftIndex(window_id=msg.window_id, indices=idx))
        self._record_stats(msg, times_b, int(matched.sum()), int(idx.size),
                           residual)

    @staticmethod
    def _pfind_times(ta, tb, times_a: np.ndarray, times_b: np.ndarray,
                     span: int):
        """pfind's inputs: it bins [0, span) of the frame, so a stream
        whose first chunk starts past span / 2 and runs past span (a
        stream that starts late inside a frame) has its events moved back
        by its first event; the offset between the parties is the same,
        and the padding stays at DEVICE_PAD, where pfind excludes it.  A
        chunk inside [0, span), or one that starts in its first half (a
        stream that starts at a frame's start), is passed as it is."""
        if not (len(times_a) and len(times_b)):
            return ta, tb
        base = min(int(times_a[0]), int(times_b[0]))
        if base < span // 2 or max(int(times_a[-1]),
                                   int(times_b[-1])) < span:
            return ta, tb
        return (torch.where(ta < sift.DEVICE_PAD, ta - base, ta),
                torch.where(tb < sift.DEVICE_PAD, tb - base, tb))

    @staticmethod
    def _pow2(n: int, floor: int = 256) -> int:
        c = floor
        while c < n:
            c <<= 1
        return c

    def _sift_batch(self, frames: list[tuple]) -> None:
        """Batched sifting: F frames matched in one call (servo carried on
        the device between frames), one host fetch for the whole batch.
        Frames pad to the batch's sticky power-of-two event capacities."""
        F = len(frames)
        with tracing.span("sift.batch",
                          tuple(m.window_id for m, _, _ in frames)):
            with tracing.span("sift.pad"):
                self._na_cap = max(getattr(self, "_na_cap", 256), self._pow2(
                    max(len(m.times) for m, _, _ in frames)))
                self._nb_cap = max(getattr(self, "_nb_cap", 256), self._pow2(
                    max(len(t) for _, t, _ in frames)))
                na_cap, nb_cap = self._na_cap, self._nb_cap
                ta = np.full((F, na_cap), sift.DEVICE_PAD, np.int32)
                ba = np.zeros((F, na_cap), np.uint8)
                tb = np.full((F, nb_cap), sift.DEVICE_PAD, np.int32)
                bb = np.zeros((F, nb_cap), np.uint8)
                xb = np.zeros((F, nb_cap), np.uint8)
                for i, (msg, times_b, det_b) in enumerate(frames):
                    na, nb = len(msg.times), len(times_b)
                    ta[i, :na] = msg.times
                    ba[i, :na] = msg.basis
                    tb[i, :nb] = times_b
                    bb[i, :nb] = (det_b >> 1) & 1
                    xb[i, :nb] = det_b & 1
            with tracing.span("sift.upload"):
                inputs = [self._to_dev(a) for a in (ta, ba, tb, bb, xb)]
            with tracing.span("sift.match"):
                match = sift.make_frame_matcher(
                    F, self.config.coincidence_window,
                    self.config.servo_gain)
                r = match(*inputs, self.offset)
            # Device-resident epilogue: compaction and the per-frame type-4
            # index rows stay on the device; only the per-frame counts and
            # servo residuals cross to the host.  The compacted Bob bits
            # append to the EC stream as a padded device buffer with a
            # valid-prefix length.
            with tracing.span("sift.outputs"):
                idx_dev, counts_dev, bits_flat = sift.sift_outputs(
                    r.sift_mask, r.bob_bits)
            with tracing.span("sift.fetch"):
                counts = counts_dev.cpu().numpy()
                mcounts = r.matched_counts.cpu().numpy()
                residuals = r.residuals.cpu().numpy()
                final_offset = int(r.final_offset)
            # Per-frame servo trajectory for the stats (same f32-multiply +
            # truncate arithmetic as the device servo).
            offset = np.int32(self.offset)
            self.offset = final_offset
            total = int(counts.sum())
            for i, (msg, times_b, _d) in enumerate(frames):
                self.link.send(SiftIndex(window_id=msg.window_id,
                                         indices=idx_dev[i],
                                         count=int(counts[i])))
                offset = np.int32(offset + np.int32(
                    np.float32(self.config.servo_gain)
                    * np.float32(residuals[i])))
                self._record_stats(msg, times_b, int(mcounts[i]),
                                   int(counts[i]), float(residuals[i]),
                                   offset=int(offset))
        if total:
            self.ec.push_sifted(bits_flat, n=total)

    def _record_stats(self, msg: TimingBasis, times_b: np.ndarray,
                      coincidences: int, sifted: int,
                      residual: float, offset: Optional[int] = None) -> None:
        # getrate diagnostics: accidentals estimated from the uniform-rate
        # expectation (Na*Nb*2w/span — the classic accidental-coincidence
        # formula on the frame).
        na, nb = int(len(msg.times)), int(len(times_b))
        span = max(1, int(times_b.max()) if nb else 1)
        acc = na * nb * 2.0 * self.config.coincidence_window / span
        self.sift_stats.append({
            "window_id": int(msg.window_id),
            "alice_events": na, "bob_events": nb,
            "coincidences": coincidences,
            "accidentals_est": round(acc, 2),
            "sifted_bits": sifted,
            "basis_match_ratio": round(sifted / max(1, coincidences), 4),
            "servo_residual_units": round(residual, 3),
            "offset_units": int(self.offset if offset is None else offset),
        })


def run_chain_loopback(config: ChainConfig, num_windows: int = 30,
                       source: Optional[EntangledPairSource] = None,
                       seed: int = 0, session_seed: int = 0x5E55,
                       device=DEFAULT_DEVICE, wire: bool = True):
    """End-to-end loopback: simulated entangled source through the full chain.

    Both chains run on ``device``.  ``wire=True`` serializes every message
    through the packed byte format (as the reference's loopback does);
    ``wire=False`` passes tensors over a DirectLink, so the sifted-bit
    handoff stays on the device.  Returns (alice_chain, bob_chain) after the
    stream quiesces.
    """
    rng = np.random.default_rng(seed)
    src = source or EntangledPairSource(pair_rate_hz=200_000,
                                        window_s=config.window_s)
    la, lb = make_loopback_pair() if wire else make_direct_pair()
    alice = AliceChain(config, session_seed, la, device=device)
    bob = BobChain(config, session_seed, lb, device=device)

    span_units = int(config.window_s * 1e9 * TIME_UNITS_PER_NS)
    for w in range(num_windows):
        ev: PairEvents = src.generate(rng, start_epoch=w)
        # Epoch-true streaming: absolute times; the chains split the stream
        # into device frames (epoch id = frame >> 3) themselves.
        base = np.int64(w) * span_units
        alice.push_stream(np.asarray(ev.alice.times[: ev.alice.count],
                                     np.int64) + base,
                          ev.alice.detectors[: ev.alice.count])
        bob.push_stream(np.asarray(ev.bob.times[: ev.bob.count],
                                   np.int64) + base,
                        ev.bob.detectors[: ev.bob.count])
        # Pump both sides until quiescent before the next window arrives.
        for _ in range(10_000):
            progressed = bob.pump()
            progressed = alice.pump() or progressed
            if not progressed:
                break
    # Final drain (sift any partial frame batch first).
    bob.flush_sift()
    for _ in range(10_000):
        progressed = bob.pump()
        progressed = alice.pump() or progressed
        if not progressed:
            break
    return alice, bob
