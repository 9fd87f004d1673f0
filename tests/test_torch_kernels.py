"""The port's attention kernels: plain versions against the JAX package's
Pallas kernels (interpret mode, as tests/test_kernels.py runs them) and its
oracles, on the same numpy-made inputs, and the paged decode split planner.
The CUDA kernels against their plain versions, on a card only, are in
tests/test_torch_kernels_cuda.py.

Tolerances: f32 compares at 2e-5 (the kernel and the plain versions sum in
other orders); bf16 at 2e-2 (the output's one bf16 rounding can land on
either side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill.kernel import flash_prefill_pallas
from repro.kernels.flash_prefill.ops import flash_attention as jax_flash
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_flash_ref
from repro.kernels.paged_attention.ops import paged_attention as jax_paged
from repro_torch.kernels import resolve_backend
from repro_torch.kernels.flash_prefill import ops as fp_ops
from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention.ref import (paged_attention_ref,
                                                     paged_attention_split_ref)

# one intra-op thread: the suite runs several workers on few cores, and
# torch's default pool (one thread per core) oversubscribes them
torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _both(x: np.ndarray, dtype):
    return (jnp.asarray(x, jnp.float32).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(getattr(torch, dtype)))


def _close(t, j, dtype):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


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


PAGED_CASES = [
    # B, Hq, Hkv, hd, page, P, npages, softcap, trash_row
    (2, 28, 4, 128, 16, 3, 12, 0.0, None),    # qwen2.5-7b head layout, G=7
    (3, 28, 4, 128, 16, 2, 12, 50.0, 2),      # softcap + a padded row
    (2, 4, 4, 64, 8, 4, 16, 0.0, None),       # hd=64, G=1
    (4, 4, 2, 64, 4, 8, 40, 0.0, 0),          # G=2, ragged, padded row
]


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_plain_matches_pallas_and_oracle(case, dtype):
    B, Hq, Hkv, hd, page, P, npages, cap, trash = case
    q, kp, vp, tables, lengths = _paged_inputs(B, Hq, Hkv, hd, page, P, npages,
                                               trash, seed=B + hd)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, kp, vp))
    want_kernel = jax_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths),
                            num_kv_heads=Hkv, logit_softcap=cap, interpret=True)
    want_oracle = jax_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lengths),
                            num_kv_heads=Hkv, logit_softcap=cap, use_ref=True)
    got = pa_ops.paged_attention(tq, tk, tv, torch.from_numpy(tables),
                                 torch.from_numpy(lengths), num_kv_heads=Hkv,
                                 logit_softcap=cap)
    assert got.dtype == tq.dtype and got.shape == (B, Hq, hd)
    _close(got, want_kernel, dtype)
    _close(got, want_oracle, dtype)


def test_paged_plain_ignores_table_entries_past_length():
    q, kp, vp, tables, lengths = _paged_inputs(2, 8, 2, 64, 8, 4, 16, None, seed=3)
    lengths[:] = [11, 3]
    args = [torch.from_numpy(a) for a in (q, kp, vp)]
    out1 = pa_ops.paged_attention(*args, torch.from_numpy(tables),
                                  torch.from_numpy(lengths), num_kv_heads=2)
    tables[0, 2:] = 0
    tables[1, 1:] = 15
    out2 = pa_ops.paged_attention(*args, torch.from_numpy(tables),
                                  torch.from_numpy(lengths), num_kv_heads=2)
    torch.testing.assert_close(out1, out2, atol=0, rtol=0)


# (B, Hkv, P, page_size, num_sms): the runtime's bucket at short and long
# contexts, one request, a batch that already fills the card, odd sizes
PLAN_SHAPES = [(8, 4, 32, 16, 132), (8, 4, 64, 16, 132), (8, 4, 128, 16, 132),
               (1, 4, 128, 16, 132), (64, 8, 4096, 16, 132), (3, 2, 5, 7, 20),
               (1, 1, 1, 1, 132)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_paged_split_plan_covers_every_slot_once(shape):
    """Every token slot of the table is in exactly one chunk, chunks are
    whole ring tiles no larger than the kernel's page-id buffer, and the
    plan is a function of the shapes alone (same inputs, same plan)."""
    B, Hkv, P, page, sms = shape
    chunk, splits = pa_ops.plan_splits(B, Hkv, P, page, sms)
    assert (chunk, splits) == pa_ops.plan_splits(B, Hkv, P, page, sms)
    assert chunk % pa_ops.TILE == 0 and 0 < chunk <= pa_ops.MAX_CHUNK
    owner = np.zeros(P * page, np.int64)
    for s in range(splits):
        owner[s * chunk:(s + 1) * chunk] += 1
    assert (owner == 1).all()
    assert (splits - 1) * chunk < P * page      # no chunk lies wholly past the table
    if B * Hkv < 2 * sms and P * page >= 2 * pa_ops.TILE:
        assert splits > 1                         # a small batch is split to fill the card


def test_paged_split_plan_at_the_runtime_shape():
    """Bucket 8, Hkv 4, 64 pages of 16 on 132 SMs: 8 splits of 128 tokens,
    256 blocks (about two per SM); a plan of one split when the batch alone
    fills the card."""
    assert pa_ops.plan_splits(8, 4, 64, 16, 132) == (128, 8)
    assert pa_ops.plan_splits(8, 4, 32, 16, 132) == (64, 8)
    assert pa_ops.plan_splits(64, 8, 4, 16, 132)[1] == 1


@pytest.mark.parametrize("plan", [(32, 8), (64, 4), (256, 1), (96, 3)])
@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_paged_split_merge_matches_plain(plan, cap):
    """Split-then-merge (the kernel's algorithm) over the planner's kind of
    chunks equals the one-pass plain version within 2e-5 in f32, with empty
    chunks (short rows), a row ending on a chunk boundary and a padded row
    served from the trash page."""
    chunk, splits = plan
    B, Hq, Hkv, hd, page, P = 5, 28, 4, 128, 16, 16
    q, kp, vp, tables, lengths = _paged_inputs(B, Hq, Hkv, hd, page, P, 40, 3, seed=11)
    lengths[:] = [256, 64, 1, 1, 200]              # row 3 is the padded row (trash page 0)
    args = [torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)]
    qg = args[0].reshape(B, Hkv, Hq // Hkv, hd)
    want = paged_attention_ref(qg, *args[1:], logit_softcap=cap)
    got = paged_attention_split_ref(qg, *args[1:], chunk=chunk, splits=splits,
                                    logit_softcap=cap)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


FLASH_CASES = [
    # B, Sq, Skv, Hq, Hkv, hd, softcap
    (1, 128, 128, 28, 4, 128, 0.0),   # qwen2.5-7b head layout, G=7
    (1, 64, 64, 28, 4, 128, 30.0),    # softcap
    (2, 64, 64, 2, 2, 64, 0.0),       # hd=64, G=1
    (2, 100, 100, 4, 2, 64, 0.0),     # ragged edge of a 64-row tile
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas(case, dtype):
    B, Sq, Skv, Hq, Hkv, hd, cap = case
    rng = np.random.default_rng(Sq + hd)
    q = rng.standard_normal((B, Sq, Hq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, Hkv, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    want = jax_flash(jq, jk, jv, logit_softcap=cap, interpret=True,
                     block_q=64, block_kv=64)
    got = fp_ops.flash_attention(tq, tk, tv, logit_softcap=cap)
    assert got.dtype == tq.dtype and got.shape == (B, Sq, Hq, hd)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_runtime_offset_and_kv_lens(dtype):
    """q_offset > 0 (a chunk over landed keys) against the Pallas kernel's
    compile-time q_offset/kv_len, and ragged per-row kv_lens against the
    JAX oracle; the port takes both at run time."""
    rng = np.random.default_rng(7)
    B, Sq, Skv, Hq, Hkv, hd = 2, 64, 192, 28, 4, 128
    q = rng.standard_normal((B, Hq, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, hd)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Skv, hd)).astype(np.float32)
    (jq, tq), (jk, tk), (jv, tv) = (_both(a, dtype) for a in (q, k, v))
    scale = 1.0 / np.sqrt(hd)
    want = flash_prefill_pallas(jq, jk, jv, kv_len=160, q_offset=96, scale=scale,
                                block_q=64, block_kv=64, interpret=True)
    got = fp_ops.flash_attention(
        tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2), q_offset=96,
        kv_lens=torch.tensor([160, 160], dtype=torch.int32)).transpose(1, 2)
    _close(got, want, dtype)
    lens = np.array([192, 77], np.int32)
    want = jax_flash_ref(jq, jk, jv, kv_len=Skv, q_offset=96, scale=scale,
                         kv_lens=jnp.asarray(lens))
    got = flash_prefill_ref(tq, tk, tv, kv_len=Skv, q_offset=96,
                            kv_lens=torch.from_numpy(lens))
    _close(got, want, dtype)


def test_wrappers_count_no_launches_on_cpu():
    """On CPU tensors the wrappers run the plain versions: no kernel launch
    is counted, and the backend switch never picks the kernels."""
    before = (pa_ops.paged_attention.launches, fp_ops.flash_attention.launches)
    q, kp, vp, tables, lengths = _paged_inputs(1, 4, 2, 64, 8, 2, 4, None, seed=1)
    pa_ops.paged_attention(*(torch.from_numpy(a) for a in (q, kp, vp, tables, lengths)),
                           num_kv_heads=2)
    x = torch.randn(1, 8, 2, 64)
    fp_ops.flash_attention(x, x, x)
    assert (pa_ops.paged_attention.launches, fp_ops.flash_attention.launches) \
        == before == (0, 0)
    assert resolve_backend("auto", "cpu") == "ref"
    assert resolve_backend("auto", "cuda") == "cuda"
    assert resolve_backend("ref", "cuda") == "ref"
    with pytest.raises(ValueError):
        resolve_backend("cuda", "cpu")
