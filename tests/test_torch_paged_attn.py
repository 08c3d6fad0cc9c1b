"""Paged attention of the PyTorch port (kernels/paged_attn): the plain
version against the JAX package's oracles and its Pallas kernel (run in
interpret mode on the CPU), and the wrapper's routing by device. The
hand-written kernel itself is held against the plain version on the card
by ``tests/test_torch_cuda.py``.

Inputs come from numpy seeds and reach both sides as the same arrays.
Tolerance: 1e-5 (fp32 on both sides; only the summation order differs).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.kernel import (
    paged_decode_attn_pallas,
    paged_prefill_attn_pallas,
)
from repro.kernels.decode_attn.ref import (
    paged_decode_attn_ref,
    paged_prefill_attn_ref,
)
from repro_torch.kernels.paged_attn import ops
from repro_torch.kernels.paged_attn.ref import paged_attn_ref
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)

# (B, C, H, KV, hd, ps, MP, P): P physical pages, the last is the trash
SHAPES = [
    (2, 1, 8, 2, 64, 16, 4, 12),     # GQA decode
    (3, 1, 6, 2, 128, 8, 5, 16),     # the slice's G = 6, hd 128
    (2, 4, 8, 2, 64, 16, 4, 12),     # chunk straddling pages
    (1, 7, 4, 4, 32, 8, 8, 10),      # MHA, chunk not a page multiple
    (2, 5, 12, 2, 128, 4, 6, 14),    # the slice's heads, tiny pages
]


def _case(B, C, H, KV, hd, ps, MP, P, seed):
    """q, pages, per-row pos0 and scrambled block tables whose unowned
    tails alias the trash page P - 1; a shared page is aliased by two
    rows when B > 1."""
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
        bt[1, 0] = bt[0, 0]          # prompt page shared copy-on-write
    return q, kp, vp, bt, pos0


def _port(q, kp, vp, bt, pos0):
    return paged_attn_ref(*(torch.from_numpy(a) for a in (q, kp, vp, bt,
                                                          pos0))).numpy()


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_jax_oracle(shape):
    q, kp, vp, bt, pos0 = _case(*shape, seed=sum(shape))
    out = _port(q, kp, vp, bt, pos0)
    if shape[1] == 1:
        ref = paged_decode_attn_ref(jnp.asarray(q[:, 0]), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(bt),
                                    jnp.asarray(pos0))
        np.testing.assert_allclose(out[:, 0], np.asarray(ref), **TOL)
    ref = paged_prefill_attn_ref(jnp.asarray(q), jnp.asarray(kp),
                                 jnp.asarray(vp), jnp.asarray(bt),
                                 jnp.asarray(pos0))
    np.testing.assert_allclose(out, np.asarray(ref), **TOL)


@pytest.mark.parametrize("shape", SHAPES[:4])
def test_plain_matches_pallas_interpret(shape):
    """The TPU kernel itself, run by the Pallas interpreter."""
    q, kp, vp, bt, pos0 = _case(*shape, seed=7 * sum(shape))
    out = _port(q, kp, vp, bt, pos0)
    args = (jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
            jnp.asarray(pos0))
    if shape[1] == 1:
        ref = paged_decode_attn_pallas(jnp.asarray(q[:, 0]), *args,
                                       interpret=True)
        np.testing.assert_allclose(out[:, 0], np.asarray(ref), **TOL)
    else:
        ref = paged_prefill_attn_pallas(jnp.asarray(q), *args,
                                        interpret=True)
        np.testing.assert_allclose(out, np.asarray(ref), **TOL)


def test_trash_page_contents_never_leak():
    """Whatever the trash page and unowned pages hold — here K and V of
    1e4 — the result is bitwise unchanged: those slots are always
    masked."""
    q, kp, vp, bt, pos0 = _case(2, 3, 8, 2, 64, 8, 6, 12, seed=3)
    clean = _port(q, kp, vp, bt, pos0)
    owned = {int(p) for b in range(2) for p in
             bt[b, :int(pos0[b] + 2) // 8 + 1]}
    for p in range(12):
        if p not in owned:
            kp[p] = 1e4
            vp[p] = 1e4
    np.testing.assert_array_equal(_port(q, kp, vp, bt, pos0), clean)


def test_wrapper_routes_cpu_tensors_to_plain_version():
    q, kp, vp, bt, pos0 = (torch.from_numpy(a) for a in
                           _case(2, 3, 8, 2, 64, 8, 6, 12, seed=5))
    before = (dict(ops.LAUNCHES), dict(ops.PLAIN))
    dec = ops.paged_decode_attn(q[:, 0].contiguous(), kp, vp, bt, pos0)
    pre = ops.paged_prefill_attn(q, kp, vp, bt, pos0)
    assert ops.LAUNCHES == before[0]
    assert ops.PLAIN["decode"] == before[1]["decode"] + 1
    assert ops.PLAIN["prefill"] == before[1]["prefill"] + 1
    np.testing.assert_array_equal(
        dec.numpy(), paged_attn_ref(q[:, :1], kp, vp, bt, pos0)[:, 0].numpy())
    np.testing.assert_array_equal(pre.numpy(),
                                  paged_attn_ref(q, kp, vp, bt, pos0).numpy())


def test_wrapper_refuses_non_cpu_non_cuda_operands():
    """A tensor that is neither on the CPU nor on a CUDA device is refused
    — the wrapper never quietly falls back to the plain version."""
    q, kp, vp, bt, pos0 = (torch.from_numpy(a) for a in
                           _case(1, 1, 4, 2, 64, 8, 2, 4, seed=9))
    with pytest.raises(ValueError):
        ops.paged_decode_attn(q[:, 0].to("meta"), kp, vp, bt, pos0)
