"""The contiguous decode attention of the PyTorch port against the JAX
package on numpy-seeded inputs: the plain version
(``kernels/decode_attn/ref.py``) against the JAX oracle
``decode_attn_ref`` and against the JAX kernel ``ops.decode_attn`` run
the way ``tests/test_kernels.py`` runs it on the CPU (the Pallas
interpreter, here with a 32-slot S tile so every cache spans several
tiles). The sweep covers global, sliding-window and ring caches, position
0, caches that are not a multiple of the tile, and fp32 and bf16 inputs.
Tolerance: 1e-5 in fp32 (einsum / softmax order differs between XLA and
PyTorch) and 2e-3 with bf16 inputs (both sides widen the same bf16
values to fp32; the Pallas kernel sums per tile). Plus the wrapper's
routing: CPU tensors go to the plain version, mixed devices and
unsupported shapes raise. The kernel itself runs on the card only
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attn as jax_decode_attn
from repro.kernels.decode_attn.ref import decode_attn_ref as jax_ref
from repro_torch.kernels import build as kernel_build
from repro_torch.kernels.decode_attn import ops
from repro_torch.kernels.decode_attn.ref import decode_attn_ref
from torch_threads import one_torch_thread  # noqa: F401

# (B, H, KV, hd, S, pos, window, ring)
CASES = {
    "global": (2, 12, 2, 128, 95, 90, 0, False),
    "pos0": (1, 8, 2, 64, 40, 0, 0, False),
    "S_not_tile_multiple": (2, 6, 2, 64, 100, 99, 0, False),
    "window": (2, 6, 3, 64, 150, 120, 32, False),
    "ring_wrapped": (2, 4, 1, 64, 48, 130, 48, True),
    "ring_window_below_size": (1, 8, 2, 64, 64, 200, 40, True),
    "ring_not_wrapped": (1, 4, 2, 64, 64, 20, 64, True),
}
DTYPES = {"fp32": (torch.float32, jnp.float32, 1e-5),
          "bf16": (torch.bfloat16, jnp.bfloat16, 2e-3)}


def _inputs(B, H, KV, hd, S, seed, tdtype):
    """q, k, v as torch tensors of ``tdtype`` and as fp32 numpy arrays
    holding exactly the same values."""
    r = np.random.default_rng(seed)
    arrs = [r.standard_normal(s).astype(np.float32)
            for s in ((B, H, hd), (B, S, KV, hd), (B, S, KV, hd))]
    ts = [torch.from_numpy(a).to(tdtype) for a in arrs]
    return ts, [t.float().numpy() for t in ts]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_and_pallas_kernel(case, dtype):
    B, H, KV, hd, S, pos, window, ring = CASES[case]
    tdtype, jdtype, tol = DTYPES[dtype]
    (q, k, v), arrs = _inputs(B, H, KV, hd, S, seed=S + pos, tdtype=tdtype)
    jq, jk, jv = (jnp.asarray(a).astype(jdtype) for a in arrs)
    out = decode_attn_ref(q, k, v, pos, window=window, ring=ring)
    assert out.dtype == torch.float32 and out.shape == (B, H, hd)
    ref = jax_ref(jq, jk, jv, pos, window=window, ring=ring)
    pallas = jax_decode_attn(jq, jk, jv, pos, window=window, ring=ring,
                             tile_s=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas), rtol=tol,
                               atol=tol)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    (q, k, v), _ = _inputs(2, 6, 2, 64, 30, seed=1, tdtype=torch.float32)
    launches, plain = dict(ops.LAUNCHES), dict(ops.PLAIN)
    out = ops.decode_attn(q, k, v, np.int32(17), window=8)
    assert ops.PLAIN["decode"] == plain["decode"] + 1
    assert ops.LAUNCHES == launches
    torch.testing.assert_close(out, decode_attn_ref(q, k, v, 17, window=8),
                               rtol=0, atol=0)
    assert not kernel_build._LOADED        # no kernel was built or loaded


def test_wrapper_refuses_mixed_devices_and_unsupported_inputs():
    (q, k, v), _ = _inputs(2, 6, 2, 64, 30, seed=2, tdtype=torch.float32)
    with pytest.raises(ValueError):          # K on another device
        ops.decode_attn(q, k.to("meta"), v, 5)
    with pytest.raises(ValueError):          # H not a multiple of KV
        ops.decode_attn(q[:, :5].contiguous(), k, v, 5)
    with pytest.raises(ValueError):          # k and v of different shapes
        ops.decode_attn(q, k, v[:, :20].contiguous(), 5)
    with pytest.raises(ValueError):          # q without its head axis
        ops.decode_attn(q[:, 0], k, v, 5)
    with pytest.raises(ValueError):          # the token's slot is not in
        ops.decode_attn(q, k, v, 30)         # a non-ring cache
    with pytest.raises(ValueError):
        ops.decode_attn(q, k, v, -1)
    with pytest.raises(TypeError):           # pos stays on the host
        ops.decode_attn(q, k, v, torch.tensor(5))
    ops.decode_attn(q, k, v, 30, ring=True)  # a ring cache wraps
