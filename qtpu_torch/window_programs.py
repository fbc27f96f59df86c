"""Per-window device programs of the reconciliation pipeline, in PyTorch.

Counterpart of ``qtpu/window_programs.py``.  Each window consumes a
constant B*P bits of the device stream; the programs frame, encode, pin
disclosures, assemble LLRs, decode, verify and privacy-amplify on the
stream's device, with the same protocol randomness as the
reference (threefry2x32 from ``qtpu_torch.random``, folded by GLOBAL block
index; each program makes all of its draws in one table, one launch of
the kernel on a card, with the key words read from the host header), so a
window's syndromes, hashes, disclosures, decoded payload, stats and PA
rows equal the reference's bit for bit.

Programs per ladder rung (the adaptive disclosure sizes s and k are header
values):

  alice:        (arena, header) -> (payload, syn, hashes, test_bits,
                                    short_vals)
  bob:          (arena, header, test_alice, short_alice, syn, exp_hashes,
                 qmag) -> (hat, rx_orig, rx_pin, pinmask, stats[, gled])
  retry_gather: (payload, positions) -> (B, k_r) disclosed retry bits
  retry:        re-decode the failed blocks (any number of rows) with
                extra pinned disclosures and merge them back
  pa:           (payload, pakey) -> (B, l_max) uint8 final-key rows
  pack:         (B, L) uint8 -> (B, ceil(L/32)) int32 words (uint32 bit
                patterns, LSB-first)

PyTorch runs eagerly, so the 12-word header stays a host numpy array and
its fields are plain Python ints; index arrays chosen by the host protocol
(retry positions and rows) arrive as numpy too.  The decoder (layered or
flooding min-sum) is its Hopper kernel for CUDA tensors and its plain
PyTorch version for CPU tensors (``qtpu_torch.ldpc.cuda_bp``); so are the
work the reference's XLA fuses around it: Alice's syndrome encoder, which
reads the codeword's payload, shortening-fill and puncture-pad columns
where they lie (``qtpu_torch.ldpc.encode``, ``csrc/qc_encode.cu``),
Bob's pins, mismatch count and LLRs (``qtpu_torch.window_assembly``,
``csrc/pin_llr.cu``), and the verify hash with Bob's decode tail: the
payload extract, the pin merge, ok, the error count and the retries'
merges (``qtpu_torch.window_verify``, ``csrc/verify.cu``).

With a mesh (``qtpu_torch.parallel.Mesh``), ``bob`` runs the single-device
body once per local shard on that shard's rows and device (protocol
randomness folded by the GLOBAL block index, so sharding changes no bit),
with no host sync between the shards and each CUDA shard on a stream of
its own (``Mesh.run_shards``), and adds the psum'd decode-stage
ledger ``gled`` (BASELINE config 5); its pin mask comes back as uint8.
``retry`` and ``pa`` stay unsharded on ``device``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from qtpu_torch import random as tr
from qtpu_torch import window_assembly as wa
from qtpu_torch import window_verify as wv
from qtpu_torch.accounting import LEDGER_FIELDS
from qtpu_torch.ldpc.codes import QCCode
from qtpu_torch.pa import _toeplitz_hash
from qtpu_torch.parallel import psum_ledger
from qtpu_torch.ldpc.decode import make_batch_decoder
from qtpu_torch.ldpc.encode import ColumnLayout, make_parts_encoder

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
    pa: callable
    pack: callable
    l_max: int
    k_pb: int       # max QBER test bits per block (runtime k <= this)
    s_max: int      # max disclosed-shortening bits per block
    retry_bits: int  # retry disclosure bits per block


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
    nb, z = code.nb, code.z
    # Column-class layout: codeword columns ordered payload | short | punct,
    # then one static permutation back to base-column order.
    layout = ColumnLayout(nb, z, pay_cols, short_cols, punct_cols)
    encode = make_parts_encoder(code, layout)
    if mesh is not None and B % mesh.size:
        raise ValueError(f"{B} blocks per window do not split into "
                         f"{mesh.size} shards")

    def _t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def _frame(arena, header, b, row0, dev):
        """(b, P) payload slab on ``dev``: a copy of the stream at the
        cursor (the arena is updated in place by later pushes and
        compactions)."""
        off = int(header[0]) + row0 * P
        return arena[off:off + b * P].to(dev, copy=True).reshape(b, P)

    # A program's draws (``qtpu_torch.random``), all made in one table.
    def _test_offsets(header, rows):
        """The (b,) per-block offsets of the test family of disclosure
        positions (``window_assembly.disclosure_positions``)."""
        return tr.Randint(header[2:4], (TAG_TOFF,), rows, P)

    def _verify_seed(header):
        """The window-level (1, P + Vh - 1) verify seed."""
        return tr.SeedRows(header[2:4], (TAG_VERIFY,), range(1), P + Vh - 1)

    def _shortfill(header, rows):
        """The (b, Ns·z) shortening-fill bits of the shortened columns, or
        None where the rung has none."""
        if not short_cols.size:
            return None
        return tr.SeedRows(header[2:4], (TAG_SHORTFILL,), rows,
                           int(short_cols.size) * z)

    def _draw(dev, *table):
        """The outputs of ``table``'s draws (None for a None entry), from
        one ``tr.draws`` call (none without a draw)."""
        live = [d for d in table if d is not None]
        made = iter(tr.draws(live, dev) if live else ())
        return [None if d is None else next(made) for d in table]

    def _affine(header):
        return int(header[7]), int(header[8]), int(header[9])

    def alice_program(arena, header):
        rows = range(B)
        payload = _frame(arena, header, B, 0, device)
        pad = (tr.SeedRows(header[4:6], (), rows, int(punct_cols.size) * z)
               if punct_cols.size else None)
        punct, fill, vseed, boff_t = _draw(
            device, pad, _shortfill(header, rows), _verify_seed(header),
            _test_offsets(header, rows))
        # The codeword's parts go to the encoder as they are: it reads each
        # base column from its part (no assembled codeword).
        syn = encode(payload, fill, punct)
        hashes = wv.hash(payload, vseed[0])
        pos_s, pos_t = wa.disclosure_positions(_affine(header), boff_t, P,
                                               Sm, Kq)
        short_vals = payload[:, pos_s]                       # (B, Sm)
        test_vals = torch.gather(payload, 1, pos_t)          # (B, Kq)
        return payload, syn, hashes, test_vals, short_vals

    def _decode_core(vseed, rx_orig, rx_pin, pinmask, llr, syndromes,
                     exp_hashes, **merge):
        """Decode the assembled ``llr`` -> verify against the verify seed
        ``vseed`` and merge (``window_verify.tail``'s mode: ``mism`` for
        the first decode, ``rows`` for a retry).  Returns (hat, stats (B,
        4))."""
        res = decoder(llr, syndromes.contiguous())
        return wv.tail(res.bits, rx_pin, pinmask, rx_orig, vseed[0],
                       exp_hashes.contiguous(), res.converged,
                       res.iterations, layout, **merge)

    def _bob_core(arena, header, test_alice, short_alice, syndromes,
                  exp_hashes, qmag, row0, dev):
        """Bob's decode of the b = len(test_alice) blocks from global block
        ``row0`` on, on ``dev``."""
        b = test_alice.shape[0]
        rows = range(row0, row0 + b)    # global block indices
        rx_orig = _frame(arena, header, b, row0, dev)
        boff_t, fill, vseed = _draw(dev, _test_offsets(header, rows),
                                    _shortfill(header, rows),
                                    _verify_seed(header))
        # Pin disclosed positions to Alice's (true) values (disclosure
        # doubles as shortening), count the mismatches and assemble the
        # LLR: one pass (window_assembly).
        rx_pin, pinmask, mism, llr = wa.pin_llr(
            rx_orig, short_alice, test_alice, boff_t, _affine(header),
            int(header[1]), int(header[6]), Sm, fill, qmag, layout)
        hat, stats = _decode_core(vseed, rx_orig, rx_pin, pinmask, llr,
                                  syndromes, exp_hashes, mism=mism)
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

            def shard(g, dev):
                r = slice(g * bl, (g + 1) * bl)
                out = _bob_core(arena, header, test_alice[r].to(dev),
                                short_alice[r].to(dev),
                                syndromes[r].to(dev), exp_hashes[r].to(dev),
                                qmag, g * bl, dev)
                base_t, per_ok_t, e_qber_t = ledger_parts[dev]
                okc = out[4][:, 0].sum(dtype=torch.int32)
                return out, base_t + (k + s) * bl * e_qber_t + okc * per_ok_t

            outs, leds = zip(*mesh.run_shards(shard))
            hat, rx_orig, rx_pin, pinmask, stats = (
                torch.cat([o[i].to(device) for o in outs]) for i in range(5))
            gled = psum_ledger(leds, mesh).to(device)
            return hat, rx_orig, rx_pin, pinmask.to(torch.uint8), stats, gled

    def retry_gather(payload, positions):
        """Alice's disclosed bits at the retry positions, all blocks (the
        link/wire layer slices failed rows; leakage is charged per failed
        block only)."""
        return payload[:, _t(positions)]

    def retry(arena, header, rx_orig, rx_pin, pinmask, hat, stats, rows,
              positions, bits, syndromes, exp_hashes, qmag):
        """Blind-reconciliation retry: pin Alice's disclosed bits (``bits``
        (B, k_r), at ``positions``) in the failed rows ``rows`` (host window
        indices, each once, any count), re-decode only those rows and
        merge them into the previous round's ``hat`` and ``stats``."""
        pinmask = pinmask.to(torch.bool)
        sel_rows = np.asarray(rows, np.int64)
        sel = _t(sel_rows)
        pos = _t(positions)
        bits = torch.as_tensor(bits, device=device)
        rx2_rows = rx_pin[sel]
        rx2_rows[:, pos] = bits[sel]
        pin2_rows = pinmask[sel]
        pin2_rows[:, pos] = True
        fill, vseed = _draw(device, _shortfill(header, sel),
                            _verify_seed(header))
        llr = wa.llr(rx2_rows, pin2_rows, fill, qmag, layout)
        hat_m, stats_m = _decode_core(vseed, rx_orig, rx2_rows, pin2_rows,
                                      llr, syndromes[sel], exp_hashes,
                                      hat=hat, stats=stats, rows=sel_rows)
        rx_pin_m = rx_pin.clone()
        rx_pin_m[sel] = rx2_rows
        pin_m = pinmask.clone()
        pin_m[sel] = pin2_rows
        return hat_m, rx_pin_m, pin_m, stats_m

    def pa_program(payload, pakey_data):
        b = payload.shape[0]
        if l_max == 0:   # rung can never yield key
            return torch.zeros((b, 0), dtype=torch.uint8, device=device)
        t = tr.seed_rows_at(pakey_data, (), range(b), P + l_max - 1, device)
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
                          retry_gather=retry_gather, retry=retry,
                          pa=pa_program, pack=pack_rows,
                          l_max=l_max, k_pb=Kq, s_max=Sm, retry_bits=Kr)
