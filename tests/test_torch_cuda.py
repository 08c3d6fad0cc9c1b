"""The hand-written CUDA kernels of the PyTorch port against their plain
versions, on the card. Every test here is marked ``cuda`` and skips
without a CUDA device. The file imports neither jax nor the JAX package,
so it also runs on a machine without them:

  PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attn import ops as decode_ops
from repro_torch.kernels.decode_attn.ref import decode_attn_ref
from repro_torch.kernels.paged_attn import ops
from repro_torch.kernels.paged_attn.ref import paged_attn_ref
from torch_threads import one_torch_thread  # noqa: F401

# (B, C, H, KV, hd, ps, MP, P): P physical pages, the last is the trash
SHAPES = [
    (2, 1, 8, 2, 64, 16, 4, 12),      # GQA decode
    (3, 1, 6, 2, 128, 8, 5, 16),      # G = 6, hd 128
    (2, 4, 8, 2, 64, 16, 4, 12),      # chunk straddling pages
    (2, 5, 12, 2, 128, 4, 6, 14),     # the slice's heads, tiny pages
    (16, 1, 12, 2, 128, 64, 3, 40),   # the slice's decode pool
    (1, 64, 12, 2, 128, 64, 2, 4),    # the slice's prefill chunk
    (2, 33, 4, 1, 64, 32, 3, 8),      # MQA, several row tiles
]


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _case(B, C, H, KV, hd, ps, MP, P, seed):
    """Scrambled block tables whose unowned tails alias the trash page
    P - 1, with one page shared by two rows."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, C, H, hd)).astype(np.float32)
    kp = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    vp = rng.standard_normal((P, ps, KV, hd)).astype(np.float32)
    pos0 = rng.integers(0, MP * ps - C + 1, size=B).astype(np.int32)
    bt = np.full((B, MP), P - 1, np.int32)
    for b in range(B):
        owned = int(pos0[b] + C - 1) // ps + 1
        bt[b, :owned] = rng.choice(P - 1, size=owned, replace=False)
    if B > 1:
        bt[1, 0] = bt[0, 0]
    return tuple(torch.from_numpy(a).cuda() for a in (q, kp, vp, bt, pos0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_paged_attn_kernel_matches_plain(shape, dtype):
    """fp32 to 1e-4; bf16 inputs (both sides accumulate in fp32 from the
    same bf16 values, in another order) to 2e-3."""
    _cuda_or_skip()
    q, kp, vp, bt, pos0 = _case(*shape, seed=11 * sum(shape))
    q, kp, vp = q.to(dtype), kp.to(dtype), vp.to(dtype)
    before = dict(ops.LAUNCHES)
    out = ops.paged_prefill_attn(q, kp, vp, bt, pos0)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["prefill"] == before["prefill"] + 1
    ref = paged_attn_ref(q, kp, vp, bt, pos0)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    if shape[1] == 1:
        dec = ops.paged_decode_attn(q[:, 0].contiguous(), kp, vp, bt, pos0)
        torch.testing.assert_close(dec, out[:, 0], rtol=0, atol=0)
        assert ops.LAUNCHES["decode"] == before["decode"] + 1


@pytest.mark.cuda
def test_paged_attn_wrapper_refuses_unsupported_inputs():
    _cuda_or_skip()
    q, kp, vp, bt, pos0 = _case(1, 1, 4, 2, 32, 8, 2, 4, seed=13)
    with pytest.raises(ValueError):           # head dim 32 has no kernel
        ops.paged_decode_attn(q[:, 0].contiguous(), kp, vp, bt, pos0)
    q, kp, vp, bt, pos0 = _case(1, 1, 4, 2, 64, 8, 2, 4, seed=13)
    with pytest.raises(ValueError):           # int64 positions
        ops.paged_decode_attn(q[:, 0].contiguous(), kp, vp, bt, pos0.long())
    with pytest.raises(ValueError):           # mixed devices
        ops.paged_decode_attn(q[:, 0].contiguous(), kp.cpu(), vp, bt, pos0)


# contiguous decode: (B, H, KV, hd, S, pos, window, ring)
DECODE_SHAPES = [
    (8, 12, 2, 128, 95, 94, 0, False),      # the engine path, 2 S tiles
    (1, 12, 2, 128, 95, 60, 0, False),      # one row, pos in the 1st tile
    (2, 8, 2, 128, 33, 0, 0, False),        # position 0
    (1, 40, 2, 64, 70, 69, 0, False),       # G = 20: two query-row tiles
    (2, 6, 3, 64, 150, 120, 32, False),     # sliding window
    (2, 4, 1, 64, 48, 130, 48, True),       # ring, wrapped
    (1, 8, 2, 128, 64, 200, 40, True),      # ring, window below its size
    (8, 12, 2, 128, 4096, 4000, 0, False),  # a long cache
]


def _decode_case(B, H, KV, hd, S, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                 .cuda() for s in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", DECODE_SHAPES)
def test_decode_attn_kernel_matches_plain(shape, dtype):
    """fp32 to 1e-4; bf16 inputs (both sides accumulate in fp32 from the
    same bf16 values, in another order) to 2e-3."""
    _cuda_or_skip()
    B, H, KV, hd, S, pos, window, ring = shape
    q, k, v = (t.to(dtype) for t in _decode_case(B, H, KV, hd, S,
                                                  seed=sum(shape)))
    before = decode_ops.LAUNCHES["decode"]
    out = decode_ops.decode_attn(q, k, v, pos, window=window, ring=ring)
    torch.cuda.synchronize()
    assert decode_ops.LAUNCHES["decode"] == before + 1
    ref = decode_attn_ref(q, k, v, pos, window=window, ring=ring)
    tol = 1e-4 if dtype == torch.float32 else 2e-3
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_decode_attn_kernel_gates_stale_slots():
    """Slots past the position hold NaN (stale data of a reused cache):
    the kernel never reads them, so its output equals the plain version's
    on the same cache with those slots zeroed."""
    _cuda_or_skip()
    q, k, v = _decode_case(4, 12, 2, 128, 95, seed=5)
    clean = (k.clone(), v.clone())
    k[:, 71:] = float("nan")
    v[:, 71:] = float("nan")
    for t in clean:
        t[:, 71:] = 0.0
    out = decode_ops.decode_attn(q, k, v, 70)
    ref = decode_attn_ref(q, *clean, 70)
    assert torch.isfinite(out).all()
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_decode_attn_wrapper_refuses_unsupported_inputs():
    _cuda_or_skip()
    q, k, v = _decode_case(1, 4, 2, 32, 16, seed=13)
    with pytest.raises(ValueError):           # head dim 32 has no kernel
        decode_ops.decode_attn(q, k, v, 3)
    q, k, v = _decode_case(1, 4, 2, 64, 16, seed=13)
    with pytest.raises(ValueError):           # mixed dtypes
        decode_ops.decode_attn(q, k.to(torch.bfloat16), v, 3)
    with pytest.raises(ValueError):           # not contiguous
        decode_ops.decode_attn(q, k.transpose(1, 2).contiguous()
                               .transpose(1, 2), v, 3)
    with pytest.raises(ValueError):           # mixed devices
        decode_ops.decode_attn(q, k.cpu(), v, 3)
    with pytest.raises(TypeError):            # pos stays on the host
        decode_ops.decode_attn(q, k, v, torch.tensor(3, device="cuda"))
