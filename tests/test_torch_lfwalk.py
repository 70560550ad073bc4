"""Kernel K2's plain versions (`decode_walks_ref`, `locate_walks_ref`).

Each is held equal to a direct numpy loop (one walk at a time) and to
gecoz_tpu's own walks on the same block: the full walks of
`decode_text_jit` and the fused-table branch of `locate_batch`.  The
probe's `k_walk` (tools/probe_gather2d.py:84-92: walks over a packed
(lf << 8) | sym table, idx = v >> 8) is run at a small size.  Everything
is an integer or a byte: tolerance 0.  The kernel itself runs only on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from gecoz_tpu.ops import fmq as ref_fmq
from gecoz_tpu.ops.sa import suffix_array_numpy
from gecoz_tpu_torch.ops import fmq, lfwalk

from conftest import random_block
from test_fm import build_fm
from test_torch_host_copies import build_port_fm

torch.set_num_threads(1)


def loop_decode(tab, seeds, rate, mode, bwt, cmap):
    """decode_walks, one walk and one row read at a time (uint32 rows)."""
    k, _ = lfwalk.MODES[mode]
    out = np.zeros((len(seeds), rate), np.uint8)
    for w, idx in enumerate(seeds):
        idx = int(idx)
        for r in range(rate // k):
            if k == 1:
                v = int(tab[idx])
                out[w, rate - 1 - r] = v & 255 if mode == "packed" \
                    else bwt[idx]
                idx = (v >> 8) & 0x7FFFFF if mode == "packed" \
                    else v & 0x7FFFFFFF
                continue
            row = [int(x) for x in tab[idx]]
            for s in range(k):
                if mode == "lfk4":
                    sym = (row[1] >> (8 * s)) & 255
                else:
                    sym = cmap[(row[1 + s // 8] >> (4 * (s % 8))) & 15]
                out[w, rate - 1 - (r * k + s)] = sym
            idx = row[0]
    return out


def _block(rng, rate, packed, monkeypatch):
    if not packed:
        monkeypatch.setattr(fmq, "_PACK_LIMIT", 16)
    data, _ = random_block(rng, nseq=2, minlen=200, maxlen=500,
                           alphabet=b"ACGTN")
    fm = build_fm(data, rate)
    return data, fm, fmq.with_lf_table(
        fmq.device_block_from_fm(build_port_fm(data, rate), "cpu"))


@pytest.mark.parametrize("rate,mode,packed", [
    (16, "lfk16", True), (8, "lfk8", True), (4, "lfk4", True),
    (8, "packed", True), (8, "plain", False)])
def test_decode_ref_equals_loop_and_reference(rate, mode, packed, rng,
                                              monkeypatch):
    data, fm, blk = _block(rng, rate, packed, monkeypatch)
    n = blk.n
    W = (n - 1) // rate
    seeds = fmq._row_with_sa(blk, (torch.arange(W, dtype=torch.int32) + 1)
                             * rate)
    tab = blk.lfk_tab if mode.startswith("lfk") else blk.lf_tab
    cmap = fmq.code_map(blk)
    got = lfwalk.decode_walks_ref(tab, seeds, rate, mode, bwt=blk.bwt,
                                  code_map=cmap)
    u32 = tab.numpy().view(np.uint32)
    want = loop_decode(u32, seeds.numpy(), rate, mode, blk.bwt.numpy(),
                       cmap.numpy())
    assert np.array_equal(got.numpy(), want)
    # the reference's full walks lay the text out the same way
    ref = ref_fmq.with_lf_table(ref_fmq.device_block_from_fm(fm))
    text = np.asarray(ref_fmq.decode_text_jit(ref))
    assert np.array_equal(got.numpy().reshape(-1), text[:W * rate])
    # the wrapper takes the plain version for CPU tensors, uncounted
    before = dict(lfwalk.LAUNCHES)
    assert torch.equal(lfwalk.decode_walks(tab, seeds, rate, mode,
                                           bwt=blk.bwt, code_map=cmap), got)
    assert lfwalk.LAUNCHES == before


def test_probe_k_walk_shape(rng):
    """The probe's walk (its 2 Mi rows x 2048 walks x 32 steps, cut to
    2^14 rows x 64 walks): each step reads v = tab[idx], emits it and
    goes to v >> 8; the packed mode emits v's low byte."""
    n, walks, steps = 1 << 14, 64, 32
    tab = rng.integers(0, n << 8, n).astype(np.int32)
    seeds = rng.integers(0, n, walks).astype(np.int32)
    kwalk = np.zeros((steps, walks), np.int64)      # the probe's [32, Wn]
    idx = seeds.astype(np.int64)
    for j in range(steps):
        v = tab[idx]
        kwalk[j] = v
        idx = v >> 8
    got = lfwalk.decode_walks(torch.from_numpy(tab), torch.from_numpy(seeds),
                              steps, "packed")
    assert np.array_equal(got.numpy()[:, ::-1].T, (kwalk & 255))


def loop_locate(tab, rows, mark_words, mark_pre, perm, sf, packed):
    out = []
    for idx in rows:
        idx = int(idx)
        res = -1
        for steps in range((1 << sf) + 1):
            v = int(tab[idx])
            if v >> 31:
                w = idx >> 5
                rank = int(mark_pre[w]) + bin(
                    int(mark_words[w]) & ((2 << (idx & 31)) - 1)).count("1")
                res = (int(perm[max(rank - 1, 0)]) << sf) + steps
                break
            idx = (v >> 8) & 0x7FFFFF if packed else v & 0x7FFFFFFF
        out.append(res)
    return np.asarray(out)


@pytest.mark.parametrize("packed", [True, False])
def test_locate_ref_equals_loop_and_reference(packed, rng, monkeypatch):
    data, fm, blk = _block(rng, 8, packed, monkeypatch)
    if not packed:
        monkeypatch.setattr(ref_fmq, "_PACK_LIMIT", 16)
    assert blk.lf_packed == packed
    rows = rng.integers(0, blk.n, size=200).astype(np.int32)
    args = (blk.lf_tab, torch.from_numpy(rows), blk.mark_words, blk.mark_pre,
            blk.ssa_perm, blk.sf, packed)
    got = lfwalk.locate_walks_ref(*args).numpy()
    want = loop_locate(blk.lf_tab.numpy().view(np.uint32), rows,
                       blk.mark_words.numpy().view(np.uint32),
                       blk.mark_pre.numpy(), blk.ssa_perm.numpy(), blk.sf,
                       packed)
    assert np.array_equal(got, want)
    assert np.array_equal(got, suffix_array_numpy(data)[rows])
    jax.clear_caches()
    try:
        ref = ref_fmq.with_lf_table(ref_fmq.device_block_from_fm(fm),
                                    decode=False)
        assert np.array_equal(
            np.asarray(ref_fmq.locate_batch(ref, jnp.asarray(rows))), got)
    finally:
        jax.clear_caches()
    assert np.array_equal(lfwalk.locate_walks(*args).numpy(), got)
    # a row that reaches no mark within rate+1 reads gives -1
    lone = torch.tensor([1, 2, 3, 0], dtype=torch.int32)   # a 4-cycle
    none = lfwalk.locate_walks_ref(lone << 8, torch.tensor([0, 1]),
                                   torch.zeros(1, dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32),
                                   torch.zeros(1, dtype=torch.int32), 1, True)
    assert none.tolist() == [-1, -1]


def test_wrapper_checks(rng, monkeypatch):
    _, _, blk = _block(rng, 16, True, monkeypatch)
    seeds = torch.zeros(3, dtype=torch.int32)
    cmap = fmq.code_map(blk)
    with pytest.raises(ValueError):
        lfwalk.decode_walks(blk.lfk_tab, seeds, 16, "lfk32", code_map=cmap)
    with pytest.raises(ValueError):
        lfwalk.decode_walks(blk.lfk_tab, seeds, 24, "lfk16", code_map=cmap)
    with pytest.raises(TypeError):
        lfwalk.decode_walks(blk.lfk_tab, seeds, 16, "lfk8", code_map=cmap)
    with pytest.raises(TypeError):
        lfwalk.decode_walks(blk.lfk_tab, seeds, 16, "lfk16")
    with pytest.raises(TypeError):
        lfwalk.decode_walks(blk.lf_tab, seeds, 4, "plain")
    with pytest.raises(TypeError):
        lfwalk.decode_walks(blk.lf_tab, seeds.long(), 4, "packed")
    with pytest.raises(IndexError):
        lfwalk.locate_walks(blk.lf_tab, torch.tensor([blk.n], dtype=torch.int32),
                            blk.mark_words, blk.mark_pre, blk.ssa_perm,
                            blk.sf, True)


@pytest.mark.parametrize("case", ["lfk16 second row", "lfk8 word offset",
                                  "lfk16 rate 48"])
def test_decode_refuses_what_the_kernel_cannot_walk(case, rng, monkeypatch):
    """The lfk kernel reads rows in 8-byte loads and stages min(rate, 32)
    bytes a walk: a table off an 8-byte boundary, or a rate past 32 that
    is no multiple of 32, is refused on every device."""
    rate = 48 if case.endswith("48") else 16
    _, _, blk = _block(rng, 16, True, monkeypatch)
    cmap = fmq.code_map(blk)
    seeds = torch.zeros(3, dtype=torch.int32)
    tab, mode = blk.lfk_tab, "lfk16"
    if case == "lfk16 second row":
        tab = blk.lfk_tab[1:]                    # 12 bytes in
    elif case == "lfk8 word offset":
        tab, mode = torch.zeros(2 * 64 + 1, dtype=torch.int32)[1:].view(
            64, 2), "lfk8"
    assert tab.is_contiguous()
    with pytest.raises(ValueError):
        lfwalk.decode_walks(tab, seeds, rate, mode, code_map=cmap)
