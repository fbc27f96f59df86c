"""Per-window device programs of the reconciliation pipeline, in PyTorch.

Counterpart of ``qtpu/window_programs.py``.  Each window consumes a
constant B*P bits of the device stream; the programs frame, encode, pin
disclosures, assemble LLRs, decode, verify and privacy-amplify on the
stream's device, with the same protocol randomness as the
reference (threefry2x32 from ``qtpu_torch.random``, folded by GLOBAL block
index), so a window's syndromes, hashes, disclosures, decoded payload,
stats and PA rows equal the reference's bit for bit.

Programs per ladder rung (the adaptive disclosure sizes s and k are header
values):

  alice:        (arena, header) -> (payload, syn, hashes, test_bits,
                                    short_vals)
  bob:          (arena, header, test_alice, short_alice, syn, exp_hashes,
                 qmag) -> (hat, rx_orig, rx_pin, pinmask, stats[, gled])
  retry_gather: (payload, positions) -> (B, k_r) disclosed retry bits
  retry:        re-decode failed blocks with extra pinned disclosures
  retry_small:  the same for at most R = 8 failed rows
  pa:           (payload, pakey) -> (B, l_max) uint8 final-key rows
  pack:         (B, L) uint8 -> (B, ceil(L/32)) int32 words (uint32 bit
                patterns, LSB-first)

PyTorch runs eagerly, so the 12-word header stays a host numpy array and
its fields are plain Python ints; index arrays chosen by the host protocol
(retry positions and rows) arrive as numpy too.  The decoder (layered or
flooding min-sum) is its Hopper kernel for CUDA tensors and its plain
PyTorch version for CPU tensors (``qtpu_torch.ldpc.cuda_bp``).

With a mesh (``qtpu_torch.parallel.Mesh``), ``bob`` runs the single-device
body once per local shard on that shard's rows and device (protocol
randomness folded by the GLOBAL block index, so sharding changes no bit),
with no host sync between the shards, and adds the psum'd decode-stage
ledger ``gled`` (BASELINE config 5); its pin mask comes back as uint8.
``retry``, ``retry_small`` and ``pa`` stay unsharded on ``device``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from qtpu_torch import random as tr
from qtpu_torch.accounting import LEDGER_FIELDS
from qtpu_torch.ldpc.codes import QCCode
from qtpu_torch.pa import _toeplitz_hash
from qtpu_torch.parallel import psum_ledger
from qtpu_torch.ldpc.decode import BIG_LLR, make_batch_decoder
from qtpu_torch.ldpc.encode import make_batch_encoder

__all__ = ["WindowPrograms", "make_window_programs", "make_header",
           "choose_affine"]

HEADER_WORDS = 12

# Window-key fold tags (both parties derive identically on device).
TAG_VERIFY, TAG_TOFF, TAG_SHORTFILL = 3, 4, 5


def choose_affine(rng_bits, P: int) -> tuple[int, int]:
    """(a, a^-1 mod P) with gcd(a, P) = 1, from an iterator of PRNG ints.
    The affine stride p_i = (a*i + b) mod P gives s DISTINCT, evenly-spread
    disclosure positions with an elementwise-invertible mask."""
    for v in rng_bits:
        a = int(v) % P
        if a > 1 and math.gcd(a, P) == 1:
            return a, pow(a, -1, P)
    raise ValueError("no invertible stride found")


def make_header(cursor: int, short_bits: int, wkey_data: np.ndarray,
                private_key_data: np.ndarray | None = None,
                test_bits_pb: int = 0, affine: tuple[int, int, int] = (1, 1, 0)
                ) -> np.ndarray:
    """One (12,) uint32 header per program call.

    [0] stream cursor (bits, absolute arena offset)
    [1] s: disclosed-shortening positions per block (runtime, <= S_max)
    [2:4] shared window key (both parties derive the same subkeys on device)
    [4:6] Alice-private key (puncture pad; zeros on Bob's side)
    [6] k: effective QBER test bits per block (runtime, <= K_max)
    [7:10] affine stride (a, a^-1 mod P, b) for the disclosure positions
    """
    h = np.zeros(HEADER_WORDS, np.uint32)
    h[0] = cursor
    h[1] = short_bits
    h[2:4] = np.asarray(wkey_data, np.uint32)
    if private_key_data is not None:
        h[4:6] = np.asarray(private_key_data, np.uint32)
    h[6] = test_bits_pb
    h[7:10] = affine
    return h


class WindowPrograms(NamedTuple):
    alice: callable
    bob: callable
    retry_gather: callable
    retry: callable
    retry_small: callable
    pa: callable
    pack: callable
    l_max: int
    k_pb: int       # max QBER test bits per block (runtime k <= this)
    s_max: int      # max disclosed-shortening bits per block
    retry_bits: int  # retry disclosure bits per block


def _check_exact_matmul(x: torch.Tensor) -> None:
    # The verify hash is an exact GF(2) product through a float32 matmul:
    # products are 0/1 and sums <= P <= 2^17 < 2^24, exact only without TF32.
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the verify hash needs full-float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def make_window_programs(code: QCCode, pay_pos: np.ndarray,
                         punct_pos: np.ndarray, short_pos: np.ndarray,
                         max_iters: int, alg: str, verify_hash_bits: int,
                         l_max: int, batch: int, k_pb: int,
                         s_max: int = 0, retry_bits: int = 0,
                         device="cpu", mesh=None) -> WindowPrograms:
    """Build the programs for one ladder rung on ``device``.

    pay_pos / punct_pos / short_pos: static variable-index arrays (the rung's
    column classes, expanded to bit positions).  l_max: the rung's maximum PA
    output length.  batch: blocks per window (B).  k_pb / s_max: maxima of
    the per-block QBER-test and disclosed-shortening position counts
    (runtime counts ride the header).  mesh: optional
    ``qtpu_torch.parallel.Mesh`` — shards Bob's program over it (B must
    split evenly) with a psum'd decode-stage ledger."""
    device = torch.device(device)
    n = code.n
    B = int(batch)
    P = int(pay_pos.size)
    assert P <= 1 << 17, "affine-mod arithmetic assumes P <= 2^17"
    Vh = int(verify_hash_bits)
    Kq = int(k_pb)
    Sm = int(s_max)
    Kr = int(retry_bits)
    pay_np = np.asarray(pay_pos, np.int64)
    # Payload positions are whole z-columns (QC structure): move between
    # payload vectors and codewords by column slices.
    pay_cols = np.unique(pay_np // code.z)
    punct_cols = np.unique(np.asarray(punct_pos, np.int64) // code.z) \
        if len(punct_pos) else np.zeros(0, np.int64)
    short_cols = np.unique(np.asarray(short_pos, np.int64) // code.z) \
        if len(short_pos) else np.zeros(0, np.int64)
    decoder = make_batch_decoder(code, max_iters, alg)
    encode = make_batch_encoder(code)
    nb, z = code.nb, code.z
    if mesh is not None and B % mesh.size:
        raise ValueError(f"{B} blocks per window do not split into "
                         f"{mesh.size} shards")

    def _t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    # Column-class layout: codeword columns ordered payload | short | punct,
    # then one static permutation back to base-column order.  The index
    # tensors exist once per device a program runs on (each shard's).
    inv_np = np.argsort(np.concatenate([pay_cols, short_cols, punct_cols]))
    devices = [device] + (mesh.devices if mesh is not None else [])
    index = {d: (torch.as_tensor(inv_np, dtype=torch.int64, device=d),
                 torch.as_tensor(pay_cols, dtype=torch.int64, device=d),
                 torch.arange(P, dtype=torch.int64, device=d))
             for d in devices}

    def _rows(b, row0, dev):
        return row0 + torch.arange(b, dtype=torch.int64, device=dev)

    def _wkey(header, dev):
        return tr.key_from_data(header[2:4], dev)

    def _frame(arena, header, b, row0, dev):
        """(b, P) payload slab on ``dev``: a copy of the stream at the
        cursor (the arena is updated in place by later pushes and
        compactions)."""
        off = int(header[0]) + row0 * P
        return arena[off:off + b * P].to(dev, copy=True).reshape(b, P)

    def _disclosure_positions(header, rows, dev):
        """(pos_s (Sm,), pos_t (b, Kq), boff_t (b,)): the shortening family
        is window-level (stride a, offset b); the test family continues the
        same stride at per-block PRNG offsets."""
        a, boff_s = int(header[7]), int(header[9])
        i = torch.arange(Sm, dtype=torch.int64, device=dev)
        pos_s = (a * i % P + boff_s) % P
        keys = tr.fold_in(tr.fold_in(_wkey(header, dev), TAG_TOFF), rows)
        boff_t = tr.randint(keys, P)
        j = torch.arange(Sm, Sm + Kq, dtype=torch.int64, device=dev)
        pos_t = ((a * j % P)[None, :] + boff_t[:, None]) % P
        return pos_s, pos_t, boff_t

    def _pin_masks(header, boff_t, dev):
        """Elementwise pin masks: position p is a shortening pin iff
        a^-1(p - b) mod P < s, a test pin iff its per-block inverse lands in
        [Sm, Sm + k)."""
        ainv, s, k = int(header[8]), int(header[1]), int(header[6])
        p_idx = index[dev][2]
        inv_s = ainv * ((p_idx + P - int(header[9])) % P) % P
        m_short = (inv_s < s)[None, :]
        inv_t = ainv * ((p_idx[None, :] + P - boff_t[:, None]) % P) % P
        m_test = (inv_t >= Sm) & (inv_t < Sm + k)
        return m_short | m_test

    def _vmatrix(header, dev):
        """(Vh, P) float32 Toeplitz verification matrix from one window-
        level seed: row j is t[j : j + P]."""
        t = tr.seed_rows(tr.fold_in(_wkey(header, dev), TAG_VERIFY),
                         _rows(1, 0, dev), P + Vh - 1)[0]
        return t.unfold(0, P, 1).to(torch.float32)

    def _verify_hash(t_mat, x_bits):
        """(b, P) x (P, Vh) -> (b, Vh) GF(2) Toeplitz hash."""
        _check_exact_matmul(x_bits)
        acc = x_bits.to(torch.float32) @ t_mat.T
        return (acc.to(torch.int32) & 1).to(torch.uint8)

    def _shortfill(header, rows, dev):
        return tr.seed_rows(tr.fold_in(_wkey(header, dev), TAG_SHORTFILL),
                            rows, int(short_cols.size) * z)

    def _build_codeword(payload, header, rows, punct_bits, dev):
        b = payload.shape[0]
        parts = [payload.reshape(b, -1, z)]
        if short_cols.size:
            parts.append(_shortfill(header, rows, dev).reshape(b, -1, z))
        if punct_cols.size:
            parts.append(punct_bits.reshape(b, -1, z))
        x = torch.cat(parts, dim=1)     # class order
        return x[:, index[dev][0], :].reshape(b, n)

    def _extract_payload(x_bits, dev):
        b = x_bits.shape[0]
        return x_bits.reshape(b, nb, z)[:, index[dev][1], :].reshape(b, P)

    def _llr(rx, pin, header, rows, qmag, dev):
        b = rx.shape[0]
        sign = 1.0 - 2.0 * rx.to(torch.float32)
        mag = torch.where(pin, BIG_LLR, float(qmag))    # float32
        parts = [(sign * mag).reshape(b, -1, z)]
        if short_cols.size:
            ssign = 1.0 - 2.0 * _shortfill(header, rows, dev).to(torch.float32)
            parts.append((ssign * BIG_LLR).reshape(b, -1, z))
        if punct_cols.size:
            parts.append(torch.zeros((b, int(punct_cols.size), z),
                                     dtype=torch.float32, device=dev))
        llr = torch.cat(parts, dim=1)[:, index[dev][0], :]
        return llr.reshape(b, n).contiguous()

    def alice_program(arena, header):
        rows = _rows(B, 0, device)
        payload = _frame(arena, header, B, 0, device)
        if punct_cols.size:
            pk = tr.key_from_data(header[4:6], device)
            punct = tr.seed_rows(pk, rows, int(punct_cols.size) * z)
        else:
            punct = None
        x = _build_codeword(payload, header, rows, punct, device)
        syn = encode(x)
        hashes = _verify_hash(_vmatrix(header, device), payload)
        pos_s, pos_t, _ = _disclosure_positions(header, rows, device)
        short_vals = payload[:, pos_s]                       # (B, Sm)
        test_vals = torch.gather(payload, 1, pos_t)          # (B, Kq)
        return payload, syn, hashes, test_vals, short_vals

    def _decode_core(header, rx_orig, rx_pin, pinmask, syndromes,
                     exp_hashes, qmag, rows, dev):
        """LLR assembly -> decode -> verify.  stats: (b,3) [ok, iters,
        errs].  Shared by the first decode and the retry re-decode."""
        llr = _llr(rx_pin, pinmask, header, rows, qmag, dev)
        res = decoder(llr, syndromes.contiguous())
        hat = torch.where(pinmask, rx_pin, _extract_payload(res.bits, dev))
        hashes = _verify_hash(_vmatrix(header, dev), hat)
        ok = (hashes == exp_hashes).all(dim=1) & res.converged
        errs = (hat ^ rx_orig).to(torch.int32).sum(dim=1, dtype=torch.int32)
        stats = torch.stack([ok.to(torch.int32),
                             res.iterations.to(torch.int32), errs], dim=1)
        return hat, stats

    def _bob_core(arena, header, test_alice, short_alice, syndromes,
                  exp_hashes, qmag, row0, dev):
        """Bob's decode of the b = len(test_alice) blocks from global block
        ``row0`` on, on ``dev``."""
        b = test_alice.shape[0]
        rows = _rows(b, row0, dev)
        rx_orig = _frame(arena, header, b, row0, dev)
        pos_s, pos_t, boff_t = _disclosure_positions(header, rows, dev)
        s, k = int(header[1]), int(header[6])
        # Pin disclosed positions to Alice's (true) values: disclosure
        # doubles as shortening.  Only the first s / k columns of the
        # static-width disclosures are live.
        rx_pin = rx_orig.clone()
        rx_pin[:, pos_s[:s]] = short_alice[:, :s]
        rx_pin.scatter_(1, pos_t[:, :k], test_alice[:, :k])
        pinmask = _pin_masks(header, boff_t, dev)
        # Every disclosed bit is a ground-truth channel sample.
        mism = (rx_pin ^ rx_orig).to(torch.int32).sum(dim=1,
                                                      dtype=torch.int32)
        hat, stats = _decode_core(header, rx_orig, rx_pin, pinmask,
                                  syndromes, exp_hashes, qmag, rows, dev)
        stats = torch.cat([stats, mism[:, None]], dim=1)
        return hat, rx_orig, rx_pin, pinmask, stats

    if mesh is None:
        def bob_program(arena, header, test_alice, short_alice, syndromes,
                        exp_hashes, qmag):
            return _bob_core(arena, header, test_alice, short_alice,
                             syndromes, exp_hashes, qmag, 0, device)
    else:
        bl = B // mesh.size
        # Per-shard decode-stage ledger = base + (k + s)·bl·e_qber +
        # okc·per_ok (okc: the shard's verified blocks), built on the
        # shard's device without a host sync.
        f = {name: i for i, name in enumerate(LEDGER_FIELDS)}
        base = np.zeros(len(LEDGER_FIELDS), np.int32)
        per_ok = np.zeros(len(LEDGER_FIELDS), np.int32)
        base[f["syndrome_bits"]] = (code.m - len(punct_cols) * z) * bl
        base[f["verify_hash_bits"]] = Vh * bl
        base[f["discarded_bits"]] = bl * P
        base[f["blocks_failed"]] = bl
        per_ok[[f["reconciled_bits"], f["discarded_bits"], f["blocks_ok"],
                f["blocks_failed"]]] = (P, -P, 1, -1)
        e_qber = np.zeros(len(LEDGER_FIELDS), np.int32)
        e_qber[f["qber_test_bits"]] = 1
        ledger_parts = {d: tuple(torch.as_tensor(v, device=d)
                                 for v in (base, per_ok, e_qber))
                        for d in mesh.devices}

        def bob_program(arena, header, test_alice, short_alice, syndromes,
                        exp_hashes, qmag):
            """The single-device body once per local shard, on its rows
            and device; results in shard order on ``device``, plus the
            psum'd ledger ``gled``."""
            s, k = int(header[1]), int(header[6])
            outs, leds = [], []
            for g, dev in mesh.local_shards():
                r = slice(g * bl, (g + 1) * bl)
                out = _bob_core(arena, header, test_alice[r].to(dev),
                                short_alice[r].to(dev),
                                syndromes[r].to(dev), exp_hashes[r].to(dev),
                                qmag, g * bl, dev)
                base_t, per_ok_t, e_qber_t = ledger_parts[dev]
                okc = out[4][:, 0].sum(dtype=torch.int32)
                leds.append(base_t + (k + s) * bl * e_qber_t + okc * per_ok_t)
                outs.append(out)
            hat, rx_orig, rx_pin, pinmask, stats = (
                torch.cat([o[i].to(device) for o in outs]) for i in range(5))
            gled = psum_ledger(leds, mesh).to(device)
            return hat, rx_orig, rx_pin, pinmask.to(torch.uint8), stats, gled

    def retry_gather(payload, positions):
        """Alice's disclosed bits at the retry positions, all blocks (the
        link/wire layer slices failed rows; leakage is charged per failed
        block only)."""
        return payload[:, _t(positions)]

    def retry_program(arena, header, rx_orig, rx_pin, pinmask, hat, stats,
                      failed, positions, bits, syndromes, exp_hashes, qmag):
        """Blind-reconciliation retry: pin Alice's disclosed bits in failed
        rows, re-decode, merge with the previous round's results."""
        pinmask = pinmask.to(torch.bool)
        pos = _t(positions)
        bits = torch.as_tensor(bits, device=device)
        failed_b = _t(failed, torch.bool)[:, None]
        rx2 = rx_pin.clone()
        rx2[:, pos] = bits
        rx2 = torch.where(failed_b, rx2, rx_pin)
        pin2 = pinmask.clone()
        pin2[:, pos] = True
        pin2 = torch.where(failed_b, pin2, pinmask)
        hat2, st2 = _decode_core(header, rx_orig, rx2, pin2, syndromes,
                                 exp_hashes, qmag, _rows(B, 0, device),
                                 device)
        failed_b = failed_b[:, 0]
        ok = stats[:, 0].to(torch.bool) | (failed_b & st2[:, 0].to(torch.bool))
        hat_m = torch.where(failed_b[:, None], hat2, hat)
        iters_m = torch.maximum(stats[:, 1], st2[:, 1])
        errs_m = torch.where(failed_b, st2[:, 2], stats[:, 2])
        stats_m = torch.stack([ok.to(torch.int32), iters_m, errs_m,
                               stats[:, 3]], dim=1)
        return hat_m, rx2, pin2, stats_m

    def retry_small(arena, header, rx_orig, rx_pin, pinmask, hat, stats,
                    rows, rows_valid, positions, bits, syndromes, exp_hashes,
                    qmag):
        """Compact retry: decode only the failed rows (``rows`` where
        ``rows_valid``; the reference's fixed R = 8 row batch and its drop-
        mode pad index are XLA shape artifacts) and merge them back."""
        pinmask = pinmask.to(torch.bool)
        sel = _t(np.asarray(rows)[np.asarray(rows_valid).astype(bool)])
        pos = _t(positions)
        bits = torch.as_tensor(bits, device=device)
        rx2_rows = rx_pin[sel]
        rx2_rows[:, pos] = bits[sel]
        pin2_rows = pinmask[sel]
        pin2_rows[:, pos] = True
        hat_r, st_r = _decode_core(header, rx_orig[sel], rx2_rows, pin2_rows,
                                   syndromes[sel], exp_hashes[sel], qmag, sel,
                                   device)
        hat_m = hat.clone()
        hat_m[sel] = hat_r
        rx_pin_m = rx_pin.clone()
        rx_pin_m[sel] = rx2_rows
        pin_m = pinmask.clone()
        pin_m[sel] = pin2_rows
        st_rows = stats[sel]
        st_new = torch.stack([st_r[:, 0],
                              torch.maximum(st_rows[:, 1], st_r[:, 1]),
                              st_r[:, 2], st_rows[:, 3]], dim=1)
        stats_m = stats.clone()
        stats_m[sel] = st_new
        return hat_m, rx_pin_m, pin_m, stats_m

    def pa_program(payload, pakey_data):
        b = payload.shape[0]
        if l_max == 0:   # rung can never yield key
            return torch.zeros((b, 0), dtype=torch.uint8, device=device)
        key = tr.key_from_data(pakey_data, device)
        t = tr.seed_rows(key, _rows(b, 0, device), P + l_max - 1)
        return _toeplitz_hash(t, payload, l_max)

    def pack_rows(bits):
        """(b, L) uint8 -> (b, ceil(L/32)) int32 words holding the uint32
        bit patterns, LSB-first (framing.pack_bits layout)."""
        b, L = bits.shape
        pad = (-L) % 32
        if pad:
            bits = torch.cat([bits, torch.zeros((b, pad), dtype=torch.uint8,
                                                device=bits.device)], dim=1)
        w = bits.reshape(b, -1, 32).to(torch.int64)
        shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
        return (w << shifts).sum(dim=-1).to(torch.int32)

    return WindowPrograms(alice=alice_program, bob=bob_program,
                          retry_gather=retry_gather, retry=retry_program,
                          retry_small=retry_small, pa=pa_program,
                          pack=pack_rows,
                          l_max=l_max, k_pb=Kq, s_max=Sm, retry_bits=Kr)
