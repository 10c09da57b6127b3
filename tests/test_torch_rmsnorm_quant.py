"""PyTorch port, kernel 1 (kernels/rmsnorm_quant.py) on the CPU: its plain
version against the JAX main path (layers.rmsnorm_quant = rmsnorm +
prepare_act, bit-equal) and against the Pallas kernel
fused_rmsnorm_quant(interpret=True). The Pallas kernel quantizes the f32
normed row while the main path (and the port) quantizes the bf16-rounded
one, so there y is bit-equal and q_x may differ by 1 LSB."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.models.layers import rmsnorm_quant as j_rmsnorm_quant
from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.mixed_linear import LinearSpec as JLS
from mixq_tpu.ops.mixed_linear import MixLinearParams as JMP
from mixq_tpu.ops.pallas.rmsnorm_quant import fused_rmsnorm_quant as pallas
from mixq_tpu_torch.kernels.rmsnorm_quant import fused_rmsnorm_quant
from mixq_tpu_torch.models.layers import rmsnorm_quant
from mixq_tpu_torch.ops import quant as TQ
from mixq_tpu_torch.ops.mixed_linear import LinearSpec, MixLinearParams


def _case(M, H, n_out, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (M, H)).astype(np.float32)
    x[:, rng.choice(H, 3, replace=False)] *= 30.0       # planted outliers
    gamma = (1 + 0.2 * rng.normal(size=H)).astype(np.float32)
    ind = np.sort(rng.choice(H, n_out, replace=False)) if n_out else None
    return x, gamma, ind


def _f32(t):
    return t.float().numpy()


@pytest.mark.parametrize("M,H,n_out", [(8, 128, 0), (16, 256, 5), (3, 64, 16)])
def test_plain_vs_main_path(M, H, n_out):
    x, gamma, ind = _case(M, H, n_out, seed=M + H)
    budget = 16
    if ind is not None:
        joset = JQ.outlier_set_from_indices(ind, H, budget)
        toset = TQ.outlier_set_from_indices(ind, H, budget, device="cpu")
    else:
        joset = toset = None
    jparams = JMP(q_weight=jnp.zeros((H, 8), jnp.int8),
                  w_scale=jnp.ones((8,)), **(dict(zip(
                      ("out_ind", "out_mask", "k_mask", "out_count"), joset))
                      if joset is not None else {}))
    tparams = MixLinearParams(q_weight=torch.zeros((H, 8), dtype=torch.int8),
                              w_scale=torch.ones(8), **(dict(zip(
                                  ("out_ind", "out_mask", "k_mask",
                                   "out_count"), toset))
                                  if toset is not None else {}))
    jy, jact = j_rmsnorm_quant(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(gamma), jparams, JLS())
    ty, tact = rmsnorm_quant(torch.from_numpy(x).to(torch.bfloat16),
                             torch.from_numpy(gamma), tparams, LinearSpec())
    np.testing.assert_array_equal(np.asarray(jy, np.float32), _f32(ty))
    np.testing.assert_array_equal(np.asarray(jact.q_x), tact.q_x.numpy())
    np.testing.assert_array_equal(np.asarray(jact.x_scale),
                                  tact.x_scale.numpy())
    if ind is None:
        assert jact.x_outlier is None and tact.x_outlier is None
    else:
        np.testing.assert_array_equal(np.asarray(jact.x_outlier, np.float32),
                                      _f32(tact.x_outlier))
        assert (tact.q_x.numpy()[:, ind] == 0).all()


@pytest.mark.parametrize("M,H,masked", [(32, 128, False), (16, 64, True)])
def test_plain_vs_pallas(M, H, masked):
    x, gamma, _ = _case(M, H, 0, seed=7 + M)
    k_mask = np.ones(H, np.float32)
    if masked:
        k_mask[[5, 17]] = 0.0
    jy, jq, js = pallas(jnp.asarray(x).astype(jnp.bfloat16),
                        jnp.asarray(gamma), jnp.asarray(k_mask),
                        interpret=True)
    ty, tq, ts, _ = fused_rmsnorm_quant(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(gamma),
        torch.from_numpy(k_mask))
    np.testing.assert_array_equal(np.asarray(jy, np.float32), _f32(ty))
    dq = np.abs(np.asarray(jq, np.int32) - tq.numpy().astype(np.int32))
    assert dq.max() <= 1, dq.max()
    # the scale comes from the absmax of f32 vs bf16-rounded y: within one
    # bf16 rounding (2**-8 relative)
    np.testing.assert_allclose(np.asarray(js), ts.numpy(), rtol=2 ** -8)
    if masked:
        assert (tq.numpy()[:, [5, 17]] == 0).all()


@pytest.mark.parametrize("H", [256, 3584, 4096, 5120])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_rmsnorm_is_the_plain_kernels_norm(H, dtype):
    """models.layers.rmsnorm (the final norm, the FP16 and W8A16 pre-norms)
    and kernel 1's plain version normalize alike, bit for bit, at the
    served widths."""
    from mixq_tpu_torch.kernels.rmsnorm_quant import rmsnorm_quant_plain
    from mixq_tpu_torch.models.layers import rmsnorm

    g = torch.Generator().manual_seed(H)
    x = (torch.randn(64, H, generator=g) * 3).to(dtype)
    gamma = 1 + 0.1 * torch.randn(H, generator=g)
    y = rmsnorm_quant_plain(x, gamma)[0]
    assert torch.equal(rmsnorm(x, gamma).view(torch.uint8),
                       y.view(torch.uint8))
