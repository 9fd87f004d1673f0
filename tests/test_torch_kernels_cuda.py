"""The port's CUDA kernels against their plain versions, on a card only.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest`` skips tests/conftest.py, which imports JAX.) Without a
card the ``cuda``-marked tests skip. Tolerance 2e-2, and 1e-2 + 2^-7 |ref|
at head dims 96, 112 and 256 and on the non-causal shapes: both sides
compute in f32 from the same bf16 inputs, and the output's one bf16
rounding can land on either side.

A softcap case scales q by CAP_Q_SCALE, so that its scores reach the cap
(at N(0, 1) scores the cap changes them by 0.2%, and a kernel that skipped
it would pass), and asserts that the plain version without the cap lies at
least 10 tolerances away from the one with it.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


CAP_Q_SCALE = 16.0


def _assert_cap_visible(want, uncapped, atol, rtol):
    """The softcap (or another fault planted in the plain version) moves the
    plain output by at least 10 tolerances."""
    want = want.float()
    r = ((uncapped.float() - want).abs() / (atol + rtol * want.abs())).max().item()
    assert r >= 10, f"the fault moves the output by only {r:.2f} tolerances"


def _paged_inputs(B, Hq, Hkv, hd, page, P, npages, trash_row, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, hd)).astype(np.float32)
    kp = rng.standard_normal((npages, page, Hkv, hd)).astype(np.float32)
    vp = rng.standard_normal((npages, page, Hkv, hd)).astype(np.float32)
    tables = rng.integers(1, npages, (B, P)).astype(np.int32)
    lengths = rng.integers(1, P * page + 1, B).astype(np.int32)
    if trash_row is not None:   # a padded batch row: trash page 0, length 1
        tables[trash_row] = 0
        lengths[trash_row] = 1
    return q, kp, vp, tables, lengths


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """Both CUDA kernels against their plain versions on the card (bf16, the
    qwen2.5-7b head layout, ragged lengths, a padded row, kv_lens and
    q_offset), and each launch counted once. Paged decode at the main path's
    plans (bucket 8 with tables of 32 and 64 pages: 8 splits of 64 and of
    128 tokens), at lengths on the planner's chunk boundaries, shorter than
    one chunk, 2048, and a table of two pages (one split); flash prefill
    also with a window and a softcap on an Sq that is no multiple of the
    query tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = "cuda"
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk, _ = pa_ops.plan_splits(8, 4, 128, 16, sms)
    # row 5 is the padded row (trash page 0, length 1); two pages of 16 is
    # a plan of one split
    assert pa_ops.plan_splits(8, 4, 2, 16, sms)[1] == 1
    for P, lens in ((32, [512, 300, 497, 64, 65, 1, 511, 129]),
                    (64, [540, 512, 129, 1000, 128, 1, 257, 33]),
                    (40, None),
                    (128, [chunk - 1, chunk, chunk + 1, 2 * chunk, 7, 1, 2048,
                           3 * chunk + 5]),
                    (2, [5, 30, 17, 32, 9, 1, 31, 2])):
        q, kp, vp, tables, lengths = _paged_inputs(8, 28, 4, 128, 16, P, 400, 5, seed=P)
        if lens is not None:
            lengths[:] = lens
        q, kp, vp = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, kp, vp))
        tables, lengths = torch.from_numpy(tables).to(dev), torch.from_numpy(lengths).to(dev)
        for cap in (0.0, 50.0):
            qc = (q.float() * CAP_Q_SCALE).bfloat16() if cap else q
            n = pa_ops.paged_attention.launches
            got = pa_ops.paged_attention(qc, kp, vp, tables, lengths, num_kv_heads=4,
                                         logit_softcap=cap)
            plain = lambda c: paged_attention_ref(  # noqa: E731
                qc.reshape(8, 4, 7, 128), kp, vp, tables, lengths,
                logit_softcap=c).reshape(q.shape)
            want = plain(cap)
            torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
            assert pa_ops.paged_attention.launches == n + 1
            if cap:
                _assert_cap_visible(want, plain(0.0), 2e-2, 2e-2)

    g = torch.Generator(dev).manual_seed(0)
    qf = torch.randn(2, 200, 28, 128, generator=g, device=dev).bfloat16()
    kf = torch.randn(2, 264, 4, 128, generator=g, device=dev).bfloat16()
    vf = torch.randn(2, 264, 4, 128, generator=g, device=dev).bfloat16()
    lens = torch.tensor([264, 130], dtype=torch.int32, device=dev)
    for window, cap in ((0, 0.0), (96, 30.0)):
        qc = (qf.float() * CAP_Q_SCALE).bfloat16() if cap else qf
        n = fp_ops.flash_attention.launches
        got = fp_ops.flash_attention(qc, kf, vf, kv_lens=lens, q_offset=64,
                                     window=window, logit_softcap=cap)
        plain = lambda c: flash_prefill_ref(  # noqa: E731
            qc.transpose(1, 2), kf.transpose(1, 2), vf.transpose(1, 2), kv_len=264,
            q_offset=64, kv_lens=lens, window=window, logit_softcap=c).transpose(1, 2)
        want = plain(cap)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
        assert fp_ops.flash_attention.launches == n + 1
        if cap:
            _assert_cap_visible(want, plain(0.0), 2e-2, 2e-2)


@pytest.mark.cuda
def test_cuda_flash_kernel_on_chunk_shapes():
    """The flash kernel on the chunk side of a mixed step: C query rows (c of
    them real) at a q_offset that is no multiple of the query tile, over one
    request's K/V gathered from a paged pool through its table (padded with
    the trash page 0 to cp pages), kv_lens = q_offset + c."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev, page, Hkv, hd = "cuda", 16, 4, 128
    g = torch.Generator(dev).manual_seed(1)
    for Sq, c, cp, off in ((16, 13, 8, 96), (256, 192, 32, 320), (256, 130, 64, 200),
                           (512, 300, 64, 200), (512, 500, 64, 320)):
        npages = 2 * cp + 1
        kp = torch.randn(npages, page, Hkv, hd, generator=g, device=dev).bfloat16()
        vp = torch.randn(npages, page, Hkv, hd, generator=g, device=dev).bfloat16()
        used = -(-(off + c) // page)
        table = torch.zeros(cp, dtype=torch.long, device=dev)
        table[:used] = torch.randperm(npages - 1, generator=g, device=dev)[:used] + 1
        k = kp[table].reshape(1, cp * page, Hkv, hd)
        v = vp[table].reshape(1, cp * page, Hkv, hd)
        q = torch.randn(1, Sq, 28, hd, generator=g, device=dev).bfloat16()
        lens = torch.tensor([off + c], dtype=torch.int32, device=dev)
        n = fp_ops.flash_attention.launches
        got = fp_ops.flash_attention(q, k, v, kv_lens=lens, q_offset=off)
        want = flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 kv_len=cp * page, q_offset=off, kv_lens=lens).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
        assert fp_ops.flash_attention.launches == n + 1


@pytest.mark.cuda
def test_cuda_kernels_at_granite_heads():
    """Both kernels at granite-moe-3b-a800m's attention shape (24 query heads
    over 8 KV heads, G = 3, head_dim 64). Paged decode on the main path's
    plans (bucket 8, tables of 32 and 64 pages, ragged lengths with a padded
    row, lengths on the planner's chunk boundaries at Hkv 8); flash prefill
    on whole prompts (S 128, 512) with a ragged row, and on chunk shapes over
    K/V gathered from a paged pool at a q_offset that is no multiple of the
    query tile."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev, Hq, Hkv, hd, page = "cuda", 24, 8, 64, 16
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    chunk, _ = pa_ops.plan_splits(8, Hkv, 64, page, sms)
    for P, lens in ((32, [512, 300, 497, 64, 65, 1, 511, 129]),
                    (64, [540, 512, 129, 1000, 128, 1, 257, 33]),
                    (64, [chunk - 1, chunk, chunk + 1, 2 * chunk, 7, 1, 1024,
                          3 * chunk + 5])):
        q, kp, vp, tables, lengths = _paged_inputs(8, Hq, Hkv, hd, page, P, 600, 5, seed=P)
        lengths[:] = lens
        q, kp, vp = (torch.from_numpy(a).to(dev, torch.bfloat16) for a in (q, kp, vp))
        tables, lengths = torch.from_numpy(tables).to(dev), torch.from_numpy(lengths).to(dev)
        n = pa_ops.paged_attention.launches
        got = pa_ops.paged_attention(q, kp, vp, tables, lengths, num_kv_heads=Hkv)
        want = paged_attention_ref(q.reshape(8, Hkv, Hq // Hkv, hd), kp, vp, tables,
                                   lengths).reshape(q.shape)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
        assert pa_ops.paged_attention.launches == n + 1

    g = torch.Generator(dev).manual_seed(2)
    for S in (128, 512):
        q = torch.randn(2, S, Hq, hd, generator=g, device=dev).bfloat16()
        k = torch.randn(2, S, Hkv, hd, generator=g, device=dev).bfloat16()
        v = torch.randn(2, S, Hkv, hd, generator=g, device=dev).bfloat16()
        lens = torch.tensor([S, S // 2 + 3], dtype=torch.int32, device=dev)
        got = fp_ops.flash_attention(q, k, v, kv_lens=lens)
        want = flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 kv_len=S, kv_lens=lens).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
    for Sq, c, cp, off in ((16, 13, 8, 96), (256, 192, 32, 320), (512, 300, 64, 200)):
        npages = 2 * cp + 1
        kp = torch.randn(npages, page, Hkv, hd, generator=g, device=dev).bfloat16()
        vp = torch.randn(npages, page, Hkv, hd, generator=g, device=dev).bfloat16()
        used = -(-(off + c) // page)
        table = torch.zeros(cp, dtype=torch.long, device=dev)
        table[:used] = torch.randperm(npages - 1, generator=g, device=dev)[:used] + 1
        k = kp[table].reshape(1, cp * page, Hkv, hd)
        v = vp[table].reshape(1, cp * page, Hkv, hd)
        q = torch.randn(1, Sq, Hq, hd, generator=g, device=dev).bfloat16()
        lens = torch.tensor([off + c], dtype=torch.int32, device=dev)
        n = fp_ops.flash_attention.launches
        got = fp_ops.flash_attention(q, k, v, kv_lens=lens, q_offset=off)
        want = flash_prefill_ref(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                 kv_len=cp * page, q_offset=off, kv_lens=lens).transpose(1, 2)
        torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)
        assert fp_ops.flash_attention.launches == n + 1


@pytest.mark.cuda
@pytest.mark.parametrize("heads,B,Sq,Skv,off,kv,window,cap", [
    # gemma2-2b (hd 256): its 6144-token prompt across the 4096 window with
    # softcap 50, and a 700-token row whose queries past 700 + 4096 see no
    # key; a chunk at q_offset > 0; a row with kv_lens 0
    ((8, 4, 256), 2, 6144, 6144, 0, [6144, 700], 4096, 50.0),
    ((8, 4, 256), 1, 200, 600, 400, [600], 256, 50.0),
    ((8, 4, 256), 2, 300, 300, 0, [300, 0], 0, 50.0),
    # phi-3-vision-4.2b (hd 96, G = 1): 1024 image + 512 text tokens; a
    # window and a softcap on a ragged row; G = 4 at a q_offset
    ((32, 32, 96), 2, 1536, 1536, 0, [1536, 1536], 0, 0.0),
    ((32, 32, 96), 2, 300, 300, 0, [300, 77], 96, 30.0),
    ((16, 4, 96), 2, 200, 264, 64, [264, 130], 0, 0.0),
])
def test_cuda_flash_kernel_at_head_dims_96_and_256(heads, B, Sq, Skv, off, kv, window, cap):
    """The flash kernel's hd 256 and hd 96 instantiations against the plain
    version, within |err| <= 1e-2 + 2^-7 |ref| (one bf16 rounding of the
    output, P rounded to bf16 before P @ V), one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = "cuda"
    Hq, Hkv, hd = heads
    g = torch.Generator(dev).manual_seed(Sq + hd)
    q = torch.randn(B, Sq, Hq, hd, generator=g, device=dev)
    q = (q * CAP_Q_SCALE if cap else q).bfloat16()
    k = torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).bfloat16()
    lens = torch.tensor(kv, dtype=torch.int32, device=dev)
    n = fp_ops.flash_attention.launches
    got = fp_ops.flash_attention(q, k, v, kv_lens=lens, q_offset=off, window=window,
                                 logit_softcap=cap)
    plain = lambda c: flash_prefill_ref(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_len=Skv,
        q_offset=off, kv_lens=lens, window=window, logit_softcap=c).transpose(1, 2)
    want = plain(cap)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=2.0 ** -7)
    assert fp_ops.flash_attention.launches == n + 1
    if cap:
        _assert_cap_visible(want, plain(0.0), 1e-2, 2.0 ** -7)


@pytest.mark.cuda
@pytest.mark.parametrize("heads,B,Sq,Skv,off,kv,window,causal,q_scale", [
    # zamba2-7b's shared attention (hd 112, on the kernel's hd 128 tiles):
    # its two prompts of 2048 and 777 tokens, a sliding window (the
    # long_context path), a chunk at q_offset > 0
    ((32, 32, 112), 2, 2048, 2048, 0, [2048, 777], 0, True, 1.0),
    ((32, 32, 112), 1, 1024, 1024, 0, [1024], 256, True, 1.0),
    ((32, 32, 112), 1, 200, 600, 400, [600], 0, True, 1.0),
    # whisper-tiny, not causal: the encoder over 1500 and 1123 frames, and
    # cross attention from prompts of 64 and 40 tokens over them (Skv 1500 is
    # no multiple of the key tile); q scaled so that each softmax picks few keys
    ((6, 6, 64), 2, 1500, 1500, 0, [1500, 1123], 0, False, CAP_Q_SCALE),
    ((6, 6, 64), 2, 64, 1500, 0, [1500, 1123], 0, False, CAP_Q_SCALE),
    ((6, 6, 64), 2, 40, 1500, 0, [1500, 1123], 0, False, CAP_Q_SCALE),
])
def test_cuda_flash_kernel_at_hd_112_and_not_causal(heads, B, Sq, Skv, off, kv, window, causal,
                                                     q_scale):
    """The flash kernel at zamba2's hd 112 and at whisper's non-causal and
    cross shapes against the plain version, within |err| <= 1e-2 + 2^-7
    |ref|, one launch counted per call; where not causal, the plain version
    with causal=True lies at least 10 tolerances away."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = "cuda"
    Hq, Hkv, hd = heads
    g = torch.Generator(dev).manual_seed(Sq + hd)
    q = (torch.randn(B, Sq, Hq, hd, generator=g, device=dev) * q_scale).bfloat16()
    k = torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).bfloat16()
    v = torch.randn(B, Skv, Hkv, hd, generator=g, device=dev).bfloat16()
    lens = torch.tensor(kv, dtype=torch.int32, device=dev)
    n = fp_ops.flash_attention.launches
    got = fp_ops.flash_attention(q, k, v, kv_lens=lens, q_offset=off, window=window,
                                 causal=causal)
    plain = lambda c: flash_prefill_ref(  # noqa: E731
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), kv_len=Skv,
        q_offset=off, kv_lens=lens, window=window, causal=c).transpose(1, 2)
    want = plain(causal)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=2.0 ** -7)
    assert fp_ops.flash_attention.launches == n + 1
    if not causal:
        _assert_cap_visible(want, plain(True), 1e-2, 2.0 ** -7)


def test_flash_wrapper_refuses_other_head_dims():
    """A head_dim the kernel was not built for raises before any launch (the
    check runs on the CPU too); a CPU tensor never reaches the kernel."""
    q = torch.zeros(1, 8, 2, 80, dtype=torch.bfloat16)
    lens = torch.tensor([8], dtype=torch.int32)
    with pytest.raises(ValueError, match="head_dim"):
        fp_ops._check(q, q, q, lens)
    assert fp_ops.HEAD_DIMS == (64, 96, 112, 128, 256)
