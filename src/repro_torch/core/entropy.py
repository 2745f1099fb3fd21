"""Canonical Huffman coding of quantized feature maps (paper Sec. III-B,
"Compression of integer feature maps"): host-side numpy, the port's own
copy of the reference codec. Build the tree from symbol frequencies,
encode to a packed bitstream, decode back with the chunk-LUT decoder.

Its bytes are the wire format both packages share: a payload encoded by
either decodes in the other.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def _code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code length per symbol (0 for absent symbols).

    Two-queue construction: leaves sorted by (freq, symbol-rank) in one
    queue, merged nodes (whose freqs are produced in non-decreasing
    order) in the other, always merging the two overall-smallest fronts.
    With ties resolved leaf-first this builds the *same* tree — depth
    vector included, not just an equally-optimal one — as a heap of
    ``(freq, insertion-counter)`` entries: both queues stay sorted by
    that pair (leaf counters all precede merge counters), so the queue
    fronts are exactly the heap minimum. O(S) merges with O(1) work
    each, instead of the heap's O(S log S) with list concatenation.
    """
    sym = np.nonzero(freqs)[0]
    if len(sym) == 0:
        return np.zeros_like(freqs)
    if len(sym) == 1:
        lengths = np.zeros_like(freqs)
        lengths[sym[0]] = 1
        return lengths
    num = len(sym)
    order = np.argsort(freqs[sym], kind="stable")     # (freq, rank) leaf order
    leaf_freq = freqs[sym][order].astype(np.int64).tolist()
    # Node ids: 0..num-1 leaves (in queue order), num.. merged nodes.
    # Plain python ints/lists in the merge loop: it is sequential by
    # nature and per-element numpy scalar access would dominate it.
    merge_freq = []
    push = merge_freq.append
    left = []
    right = []
    li = mi = 0
    for m in range(num - 1):
        # Leaf-first on equal freqs == the heap's insertion-counter
        # tie-break (leaf counters all precede merge counters).
        if li < num and (mi >= m or leaf_freq[li] <= merge_freq[mi]):
            a, fa = li, leaf_freq[li]
            li += 1
        else:
            a, fa = num + mi, merge_freq[mi]
            mi += 1
        if li < num and (mi >= m or leaf_freq[li] <= merge_freq[mi]):
            b, fb = li, leaf_freq[li]
            li += 1
        else:
            b, fb = num + mi, merge_freq[mi]
            mi += 1
        left.append(a)
        right.append(b)
        push(fa + fb)

    # Depth of every node by walking merges root-down (reverse creation).
    depth = [0] * (2 * num - 1)
    for m in range(num - 2, -1, -1):
        d = depth[num + m] + 1
        depth[left[m]] = d
        depth[right[m]] = d
    lengths = np.zeros_like(freqs)
    lengths[sym[order]] = depth[:num]
    return lengths


def _canonical_codes(lengths: np.ndarray) -> Dict[int, Tuple[int, int]]:
    """Canonical code assignment: {symbol: (code, length)}."""
    order = sorted(
        (int(l), int(s)) for s, l in enumerate(lengths) if l > 0
    )
    codes: Dict[int, Tuple[int, int]] = {}
    code = 0
    prev_len = 0
    for length, s in order:
        code <<= length - prev_len
        codes[s] = (code, length)
        code += 1
        prev_len = length
    return codes


def huffman_encode(codes_arr: np.ndarray, num_symbols: int) -> bytes:
    """Encode int array (values in [0, num_symbols)) to bytes.

    Layout: [u32 n][u16 num_symbols][u8 lengths per symbol][bitstream].
    A zero in the num_symbols field means 65536 (the 16-bit alphabet —
    zero is unreachable otherwise, so the format stays byte-identical for
    every alphabet that fits a u16).
    """
    if not (1 <= num_symbols <= 1 << 16):
        raise ValueError(f"num_symbols must be in [1, 65536], got {num_symbols}")
    flat = np.asarray(codes_arr, np.int64).reshape(-1)
    freqs = np.bincount(flat, minlength=num_symbols).astype(np.int64)
    lengths = _code_lengths(freqs)
    table = _canonical_codes(lengths)

    header = (
        np.uint32(flat.size).tobytes()
        + np.uint16(num_symbols & 0xFFFF).tobytes()
        + lengths.astype(np.uint8).tobytes()
    )
    if not table:
        return header

    # Vectorized bit emission.
    code_of = np.zeros(num_symbols, np.uint64)
    len_of = np.zeros(num_symbols, np.uint64)
    for s, (c, l) in table.items():
        code_of[s], len_of[s] = c, l
    sym_codes = code_of[flat]
    sym_lens = len_of[flat]
    ends = np.cumsum(sym_lens)
    total_bits = int(ends[-1])
    starts = ends - sym_lens
    bits = np.zeros(total_bits, np.uint8)
    # Expand each symbol's code MSB-first into the bit array.
    max_len = int(sym_lens.max())
    for l in range(1, max_len + 1):
        mask = sym_lens == l
        if not mask.any():
            continue
        s0 = starts[mask]
        c0 = sym_codes[mask]
        for j in range(l):
            bits[s0 + j] = (c0 >> np.uint64(l - 1 - j)) & np.uint64(1)
    return header + np.packbits(bits).tobytes()


# LUT window width cap: build cost is O(2^k · k), decode hops are
# O(n · H / k), and codes longer than k resolve per-symbol — 13 balances
# the three (a 16-bit window's build alone costs more than it saves).
_TABLE_K_MAX = 13
_TABLE_MIN_N = 512      # below this, the per-symbol walk beats table build


def _decode_bitwalk(stream: bytes, table, n: int) -> np.ndarray:
    """Per-symbol fallback: incremental canonical-code walk. Used for tiny
    payloads (table build would dominate) and for pathological trees with
    codes longer than ``_TABLE_K_MAX`` bits."""
    inv = {(l, c): s for s, (c, l) in table.items()}
    bits = np.unpackbits(np.frombuffer(stream, np.uint8))
    out = np.zeros(n, np.int64)
    code, length, j, i = 0, 0, 0, 0
    while j < n:
        code = (code << 1) | int(bits[i])
        i += 1
        length += 1
        sym = inv.get((length, code))
        if sym is not None:
            out[j] = sym
            j += 1
            code, length = 0, 0
    return out


def _canonical_ranges(lengths: np.ndarray):
    """Numeric canonical-code ranges: codes of length l occupy
    ``[first_code[l], first_code[l] + counts[l])`` and map to the symbols
    ``rank_sym[offset[l] + (code - first_code[l])]``."""
    max_len = int(lengths.max())
    counts = np.bincount(lengths, minlength=max_len + 1)[: max_len + 1]
    counts[0] = 0
    first_code = np.zeros(max_len + 2, np.int64)
    offset = np.zeros(max_len + 2, np.int64)
    for length in range(1, max_len + 1):
        first_code[length + 1] = (first_code[length] + counts[length]) << 1
        offset[length + 1] = offset[length] + counts[length]
    order = sorted((int(l), int(s)) for s, l in enumerate(lengths) if l > 0)
    rank_sym = np.array([s for _, s in order], np.int64)
    return first_code, offset, counts, rank_sym


def _build_chunk_table(lengths: np.ndarray, k: int, ranges):
    """Multi-symbol decode LUT over every k-bit window.

    Built fully vectorized over all 2^k windows: first a one-symbol LUT
    from the canonical numeric ``ranges`` (as computed by
    :func:`_canonical_ranges`), then chained up to ``k // min_len`` times
    to record every complete symbol inside the window. Returns
    (syms (2^k, max_emit), cnt (2^k,), used (2^k,)): the symbols fully
    contained in the window, how many, and the bits they consume.
    Windows whose first code is longer than k bits get cnt = 0 — the
    decoder resolves those (rare by construction: long codes belong to
    rare symbols) with a per-symbol range walk.
    """
    first_code, offset, counts, rank_sym = ranges
    max_len = min(int(lengths.max()), k)

    ws = np.arange(1 << k, dtype=np.int64)
    sym1 = np.zeros(1 << k, np.int64)
    len1 = np.zeros(1 << k, np.int64)
    todo = np.ones(1 << k, bool)
    for length in range(1, max_len + 1):
        if not counts[length]:
            continue
        cand = ws >> (k - length)
        idx = cand - first_code[length]
        ok = todo & (idx >= 0) & (idx < counts[length])
        sym1[ok] = rank_sym[offset[length] + idx[ok]]
        len1[ok] = length
        todo &= ~ok

    min_len = int(lengths[lengths > 0].min())
    max_emit = max(k // min_len, 1)
    syms = np.zeros((1 << k, max_emit), np.int64)
    cnt = np.zeros(1 << k, np.int64)
    used = np.zeros(1 << k, np.int64)
    cur = ws.copy()
    rem = np.full(1 << k, k, np.int64)
    active = np.ones(1 << k, bool)
    for j in range(max_emit):
        length = len1[cur]
        ok = active & (length > 0) & (length <= rem)
        syms[ok, j] = sym1[cur[ok]]
        cnt[ok] += 1
        used[ok] += length[ok]
        rem[ok] -= length[ok]
        cur[ok] = (cur[ok] << length[ok]) & ((1 << k) - 1)
        active = ok
    return syms, cnt, used


def _decode_chunked(stream: bytes, lengths: np.ndarray, n: int
                    ) -> np.ndarray:
    """Table/chunk-driven decode: the inner loop advances one k-bit window
    (several symbols) per iteration via the multi-symbol LUT, and the
    symbol emission itself is one vectorized gather over the visited
    windows — no per-symbol Python, no per-bit dict walk. Codes longer
    than the window (rare symbols in deep trees) fall back to a
    per-symbol canonical range walk for that one symbol."""
    max_len = int(lengths.max())
    k = min(_TABLE_K_MAX, max(max_len, 12))
    ranges = _canonical_ranges(lengths)
    first_code, offset, counts_per_len, rank_sym = ranges
    syms_t, cnt_t, used_t = _build_chunk_table(lengths, k, ranges)
    cu_l = list(zip(cnt_t.tolist(), used_t.tolist()))

    # 24-bit big-endian window starting at every byte: enough reach for a
    # k<=16-bit read at any intra-byte offset.
    by = np.frombuffer(stream, np.uint8).astype(np.int64)
    by_pad = np.concatenate([by, np.zeros(3, np.int64)])
    w24 = (by_pad[:-2] << 16) | (by_pad[1:-1] << 8) | by_pad[2:]
    mask = (1 << k) - 1
    shift_base = 24 - k
    w24_l = w24.tolist()
    by_l = by_pad.tolist()

    # Pass 1: walk the chain of window positions (pure scalar index math —
    # each hop consumes every complete symbol in the window). A hop whose
    # window starts with an over-long code (cnt == 0) resolves exactly one
    # symbol by the canonical ranges and records it as a negative literal.
    chain = []
    push = chain.append
    pos = 0
    emitted = 0
    while emitted < n:
        w = (w24_l[pos >> 3] >> (shift_base - (pos & 7))) & mask
        c, u = cu_l[w]
        if c:
            push(w)
            emitted += c
            pos += u
        else:
            code = w                                # the k bits read so far
            length = k
            while True:
                length += 1
                p = pos + length - 1
                code = (code << 1) | ((by_l[p >> 3] >> (7 - (p & 7))) & 1)
                idx = code - first_code[length]
                if length <= max_len and 0 <= idx < counts_per_len[length]:
                    break
            push(-(int(rank_sym[offset[length] + idx]) + 1))
            emitted += 1
            pos += length

    # Pass 2: vectorized emission over all visited windows at once;
    # literal hops contribute their single symbol in place.
    visited = np.asarray(chain, np.int64)
    literal = visited < 0
    counts = np.where(literal, 1, cnt_t[np.where(literal, 0, visited)])
    symmat = syms_t[np.where(literal, 0, visited)]
    if literal.any():
        symmat = symmat.copy()
        symmat[literal, 0] = -visited[literal] - 1
    grid = np.arange(syms_t.shape[1], dtype=np.int64)[None, :]
    picked = symmat[grid < counts[:, None]]
    return picked[:n]


def huffman_decode(data: bytes) -> np.ndarray:
    n = int(np.frombuffer(data[:4], np.uint32)[0])
    num_symbols = int(np.frombuffer(data[4:6], np.uint16)[0]) or (1 << 16)
    lengths = np.frombuffer(data[6 : 6 + num_symbols], np.uint8).astype(
        np.int64
    )
    if n == 0 or not lengths.any():
        return np.zeros(n, np.int64)
    stream = data[6 + num_symbols :]
    if n < _TABLE_MIN_N:
        # The {symbol: (code, len)} dict only exists for the per-symbol
        # walk; the chunked path works from the canonical ranges alone.
        return _decode_bitwalk(stream, _canonical_codes(lengths), n)
    return _decode_chunked(stream, lengths, n)


def huffman_size_from_counts(freqs: np.ndarray,
                             num_symbols: Optional[int] = None) -> int:
    """Exact encoded size from a symbol histogram alone. The calibration
    pipeline computes the per-bit-width histograms on device and ships
    only the ``(num_symbols,)`` counts to the host — this turns them into
    the same byte count :func:`huffman_size_bytes` reports for the full
    code array."""
    freqs = np.asarray(freqs, np.int64).reshape(-1)
    if num_symbols is None:
        num_symbols = freqs.shape[0]
    lengths = _code_lengths(freqs)
    total_bits = int((freqs * lengths).sum())
    return 6 + num_symbols + (total_bits + 7) // 8
