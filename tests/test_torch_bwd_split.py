"""The bf16 prefill backward's dk / dv split, on the CPU.

``dkdv_split`` is the host function whose table the dk / dv launch runs
(one CTA a row): these tests hold its chunks to the mask (every visible
(query head, query tile, key block) triple walked exactly once), to the
card (at least its CTA slots where the shape allows, one chunk a key
block where it has enough), to its own arguments alone, and, walked
in float64 chunk by chunk and summed in chunk order, to the plain
backward's dk and dv.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_prefill import (
    BWD_TILE,
    BWD_WORK_INTS,
    DkdvSplit,
    bwd_column_groups,
    dkdv_split,
    prefill_backward_plain,
    prefill_lse_plain,
    prefill_plain,
)

ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132

# B, Hkv, G, Lq, Lk, causal, window (0: none), q_offset, CTA slots[,
# column groups]
SPLIT_CASES = [
    (2, 2, 8, 1024, 1024, True, 0, 0, H100_SMS),     # the training cell
    (1, 2, 8, 37, 37, True, 0, 0, H100_SMS),         # ragged, one block
    (1, 1, 4, 256, 256, True, 100, 0, H100_SMS),     # window off-tile
    (1, 2, 3, 300, 300, False, 0, 0, H100_SMS),      # not causal, G 3
    (2, 1, 8, 100, 356, True, 0, 256, H100_SMS),     # q_offset, Lq != Lk
    (1, 4, 1, 200, 1500, False, 0, 0, H100_SMS),     # cross attention
    (1, 2, 4, 130, 390, True, 70, 200, H100_SMS),    # window and offset
    (1, 1, 8, 1, 300, True, 0, 299, H100_SMS),       # Lq 1
    (1, 1, 2, 200, 200, False, 50, 0, 16),           # window, not causal
    (1, 1, 2, 64, 512, True, 0, 0, H100_SMS),        # keys no query sees
    (1, 1, 8, 300, 300, True, 256, 0, H100_SMS),     # G 8, windowed
    (1, 1, 8, 300, 300, True, 100, 0, H100_SMS, 2),  # D 256: 2 groups
    (1, 1, 8, 2048, 2048, True, 512, 0, H100_SMS, 2),
    (4, 2, 8, 2048, 2048, True, 0, 0, H100_SMS),     # one chunk a block
]


def _visible(Lq, Lk, causal, window, q_offset):
    qpos = np.arange(Lq)[:, None] + q_offset
    kpos = np.arange(Lk)[None, :]
    mask = np.ones((Lq, Lk), bool)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _visible_tiles(Lq, Lk, causal, window, q_offset):
    """{(query tile, key block)} with a visible (row, key) pair, by brute
    force over the mask."""
    mask = _visible(Lq, Lk, causal, window, q_offset)
    return {(qt, kb) for qt, kb in zip(*np.nonzero(mask))
            for qt, kb in [(qt // BWD_TILE, kb // BWD_TILE)]}


def _walk(split: DkdvSplit, G: int):
    """Each row's steps as (bh, query head of the group, query tile, key
    block)."""
    for bh, kb, first, n_qt, i0, i1, *_ in split.rows:
        for i in range(i0, i1):
            yield bh, i // n_qt, first + i % n_qt, kb


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_chunks_cover_every_visible_triple_once(case):
    B, Hkv, G, Lq, Lk, causal, window, q_offset, sms, *_ = case
    split = dkdv_split(*case)
    steps = list(_walk(split, G))
    assert len(steps) == len(set(steps))
    tiles = _visible_tiles(Lq, Lk, causal, window, q_offset)
    assert set(steps) == {(bh, g, qt, kb) for bh in range(B * Hkv)
                          for g in range(G) for qt, kb in tiles}
    # every key block of every (b, KV head) has a CTA, so a block no
    # query sees still writes its zero rows
    n_kb = -(-Lk // BWD_TILE)
    assert {(r[0], r[1]) for r in split.rows} == {
        (bh, kb) for bh in range(B * Hkv) for kb in range(n_kb)}


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_chunks_of_a_key_block_are_contiguous_with_their_own_slots(case):
    split = dkdv_split(*case)
    assert all(len(r) == BWD_WORK_INTS for r in split.rows)
    blocks = {}
    for bh, kb, first, n_qt, i0, i1, slot0, j, chunks in split.rows:
        blocks.setdefault((bh, kb), []).append((j, i0, i1, slot0, chunks))
        assert i1 - i0 <= split.steps_per_chunk
    slots = []
    for (bh, kb), rows in blocks.items():
        rows.sort()
        chunks = rows[0][4]
        assert [r[0] for r in rows] == list(range(chunks))
        assert all(r[4] == chunks for r in rows)
        assert rows[0][1] == 0 and all(a[2] == b[1]
                                       for a, b in zip(rows, rows[1:]))
        slot0 = rows[0][3]
        assert all(r[3] == slot0 for r in rows)
        if chunks == 1:
            assert slot0 == -1
        else:
            slots += range(slot0, slot0 + chunks)
    assert sorted(slots) == list(range(split.slots))
    lengths = [r[5] - r[4] for r in split.rows]
    assert lengths == sorted(lengths, reverse=True)    # longest first


def _ctas(case, t):
    B, Hkv, G, Lq, Lk, causal, window, q_offset, _, *groups = case
    tiles = _visible_tiles(Lq, Lk, causal, window, q_offset)
    n_kb = -(-Lk // BWD_TILE)
    steps = [G * sum(1 for _, k in tiles if k == kb) for kb in range(n_kb)]
    return ((groups or [1])[0] * B * Hkv
            * sum(max(1, -(-n // t)) for n in steps), max(steps))


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_chunk_length_is_the_longest_that_fills_the_card(case):
    """T is the largest chunk length whose chunks give at least the
    card's CTA slots; 1 where none does, the longest walk where one chunk
    a key block already does."""
    sms = case[8]
    split = dkdv_split(*case)
    t = split.steps_per_chunk
    ctas, longest = _ctas(case, t)
    assert ctas == split.ctas
    if ctas >= sms:
        assert t >= max(1, longest) or _ctas(case, t + 1)[0] < sms
    else:
        assert t == 1


@pytest.mark.parametrize("slots,t", [(H100_SMS, 43), (2 * H100_SMS, 18)])
def test_training_cell_fills_the_card(slots, t):
    """B 2, Lq = Lk 1024, 16 / 2 heads, causal: one CTA a key block would
    be 64 CTAs, the first block's 128 steps the critical path; the split
    gives every CTA slot of the H100 a CTA (one an SM, or two: the bf16
    kernel's occupancy up to D 128) and cuts the longest chunk to T."""
    split = dkdv_split(2, 2, 8, 1024, 1024, True, 0, 0, slots)
    assert split.ctas >= slots >= H100_SMS
    assert split.steps_per_chunk == t
    assert max(r[5] - r[4] for r in split.rows) <= t
    assert sum(r[5] - r[4] for r in split.rows) == 2 * 2 * 8 * 136


def test_enough_key_blocks_keep_one_chunk_a_block():
    split = dkdv_split(4, 2, 8, 2048, 2048, True, 0, 0, H100_SMS)
    assert split.ctas == 4 * 2 * 32 and split.slots == 0
    assert all(r[8] == 1 and r[6] == -1 for r in split.rows)
    assert split.steps_per_chunk == 8 * 32


def test_split_depends_only_on_its_arguments():
    """No state outside the arguments: the cached result, a fresh one
    after the cache is cleared and calls at other shapes in between, and
    the uncached function all agree; another SM count gives another
    split."""
    case = (2, 2, 8, 1024, 1024, True, 0, 0, H100_SMS)
    first = dkdv_split(*case)
    dkdv_split.cache_clear()
    dkdv_split(1, 2, 8, 37, 37, True, 0, 0, 8)
    assert dkdv_split(*case) == first
    assert dkdv_split.__wrapped__(*case) == first
    assert dkdv_split(*case[:-1], 264) != first


def test_column_groups_hold_two_boxes_of_dk_and_dv():
    assert [bwd_column_groups(d, dv) for d, dv in
            ((64, 64), (128, 128), (96, 64), (160, 160), (256, 256))] \
        == [1, 1, 1, 2, 2]
    split = dkdv_split(1, 1, 8, 300, 300, True, 100, 0, H100_SMS, 2)
    assert split.groups == 2 and split.ctas == 2 * len(split.rows)


def test_work_row_width_matches_the_kernel():
    src = (ROOT / "src/repro_torch/csrc/flash_prefill_bwd.cu").read_text()
    assert re.search(r"constexpr int kWorkInts = (\d+);", src).group(1) \
        == str(BWD_WORK_INTS)


@pytest.mark.parametrize("case", [SPLIT_CASES[i] for i in (1, 2, 4, 6, 7,
                                                           9, 11)])
def test_chunked_walk_sums_to_the_plain_gradient(case):
    """The dk / dv launch's arithmetic order, in float64 on the CPU: each
    row's steps summed into a partial, a key block's partials summed in
    chunk order, against the plain backward's dk and dv."""
    B, Hkv, G, Lq, Lk, causal, window, q_offset, *_ = case
    Hq, D = Hkv * G, 16
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s))
                   for s in ((B, Lq, Hq, D), (B, Lk, Hkv, D),
                             (B, Lk, Hkv, D), (B, Lq, Hq, D)))
    q = q * D ** -0.5
    kw = dict(causal=causal, window=window or None, q_offset=q_offset)
    o = prefill_plain(q, k, v, **kw)
    lse = prefill_lse_plain(q, k, **kw)
    _, want_dk, want_dv = prefill_backward_plain(q, k, v, o, lse, do, **kw)
    mask = torch.from_numpy(_visible(Lq, Lk, causal, window, q_offset))
    delta = (do * o).sum(-1)                               # (B, Lq, Hq)
    split = dkdv_split(*case)
    parts = {}
    for bh, kb, first, n_qt, i0, i1, slot0, j, chunks in split.rows:
        b, hk = divmod(bh, Hkv)
        keys = slice(kb * BWD_TILE, min((kb + 1) * BWD_TILE, Lk))
        dk = torch.zeros(keys.stop - keys.start, D, dtype=torch.float64)
        dv = torch.zeros_like(dk)
        for i in range(i0, i1):
            h = hk * G + i // n_qt
            qt = first + i % n_qt
            rows = slice(qt * BWD_TILE, min((qt + 1) * BWD_TILE, Lq))
            qi, doi = q[b, rows, h], do[b, rows, h]
            s = k[b, keys, hk] @ qi.T                      # S^T
            p = torch.exp(s - lse[b, h, rows][None])
            p = torch.where(mask[rows, keys].T, p, torch.zeros(()))
            ds = p * (v[b, keys, hk] @ doi.T - delta[b, rows, h][None])
            dv += p @ doi
            dk += ds @ qi
        parts[bh, kb, j] = (dk, dv, chunks)
    got_dk, got_dv = torch.zeros_like(want_dk), torch.zeros_like(want_dv)
    for (bh, kb, j), (dk, dv, chunks) in parts.items():
        if j:
            continue
        b, hk = divmod(bh, Hkv)
        keys = slice(kb * BWD_TILE, min((kb + 1) * BWD_TILE, Lk))
        for jj in range(chunks):
            got_dk[b, keys, hk] += parts[bh, kb, jj][0]
            got_dv[b, keys, hk] += parts[bh, kb, jj][1]
    torch.testing.assert_close(got_dk, want_dk, rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(got_dv, want_dv, rtol=1e-10, atol=1e-12)
