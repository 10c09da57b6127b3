"""PyTorch port, ops/moe.py against mixq_tpu/ops/moe.py on the CPU (the
cases of tests/test_moe.py's TestMoEOp): the same float weights and
inputs, made from a numpy seed, through both packages; JAX's params carried
over by convert.py.

- expert_from_float: int8 weights and scales bit-equal (MIX), bf16 copy
  (FP16).
- expert_linear: bit-equal in W8A8 (kernel 2's expert mode, whose plain
  version sums exactly); WEIGHT_ONLY and FP16 within 1e-5 of max|y| (the
  same bf16-rounded operands summed in f32 in another order).
- moe_mlp at exact capacity, FP16 (f32 out) and W8A8, against JAX's and
  against a per-token loop in HF's semantics; with capacity drops
  (capacity_factor 1.0) against JAX's, and every token whose choices all
  fit equal to the exact run; qwen2-moe's shared expert under MIX with
  planted outlier sets on its linears (kernel 2's outlier term), without
  renormalisation; a zero router, where every probability ties, against
  JAX's (lax.top_k takes the lower experts first).
- kernel 2's plan in the expert mode counts the E x tiles output tiles.
Routing compares probabilities whose f32 sums differ from XLA's by ulps, so
each seed's gap between the k-th and the next probability is asserted
above 1e-4: a near-tie there would route the two packages apart.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import moe as jmoe
from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.mixed_linear import LinearSpec as JSpec
from mixq_tpu.ops.mixed_linear import from_float as j_from_float
from mixq_tpu_torch.convert import _moe, tensor_from_numpy
from mixq_tpu_torch.kernels import mix_gemm as K
from mixq_tpu_torch.ops import moe as tmoe
from mixq_tpu_torch.ops.mixed_linear import LinearSpec as TSpec

from test_torch_substrate import one_thread  # noqa: F401

B, T, H, I, E = 2, 5, 64, 128, 4
W8A8 = dict(version="MIX", w_bit=8, a_bit=8, out_dtype="float32")
FP16 = dict(version="FP16", w_bit=16, a_bit=16, out_dtype="float32")
W8A16 = dict(version="WEIGHT_ONLY", w_bit=8, a_bit=16, out_dtype="float32")
# the routing margin a seed must clear (see the module docstring)
MARGIN = 1e-4


def weights(seed, k=2, shared=False):
    rng = np.random.RandomState(seed)
    d = dict(x=rng.randn(B, T, H).astype(np.float32),
             router=rng.randn(H, E).astype(np.float32) * 0.5,
             w1=rng.randn(E, H, I).astype(np.float32) * 0.2,
             w3=rng.randn(E, H, I).astype(np.float32) * 0.2,
             w2=rng.randn(E, I, H).astype(np.float32) * 0.2, k=k)
    if shared:
        d.update(sg=rng.randn(H, 2 * I).astype(np.float32) * 0.1,
                 su=rng.randn(H, 2 * I).astype(np.float32) * 0.1,
                 sd=rng.randn(2 * I, H).astype(np.float32) * 0.1,
                 route=rng.randn(H, 1).astype(np.float32) * 0.3)
    return d


def jparams(d, spec, store=jnp.bfloat16, osets=None):
    def ex(w, s):
        return jmoe.expert_from_float(jnp.asarray(w), s, store)
    kw = {}
    if "sg" in d:
        s_in, s_dn = osets or (None, None)
        kw = dict(shared_gate=j_from_float(jnp.asarray(d["sg"]), spec,
                                           outlier_set=s_in),
                  shared_up=j_from_float(jnp.asarray(d["su"]), spec,
                                         outlier_set=s_in),
                  shared_down=j_from_float(jnp.asarray(d["sd"]), spec,
                                           outlier_set=s_dn),
                  shared_route=jnp.asarray(d["route"]))
    return jmoe.MoEParams(router=jnp.asarray(d["router"]),
                          gate=ex(d["w1"], spec), up=ex(d["w3"], spec),
                          down=ex(d["w2"], spec), **kw)


def to_port(jp):
    import jax

    return _moe(jax.tree.map(np.asarray, jp), "cpu")


def routing_gap(x, router, k):
    """The smallest gap between the k-th and the (k+1)-th probability."""
    logits = x.reshape(-1, x.shape[-1]) @ router
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    s = -np.sort(-p, axis=-1)
    return (s[:, k - 1] - s[:, k]).min()


def run_both(d, spec_kw, **kw):
    jspec, tspec = JSpec(**spec_kw), TSpec(**spec_kw)
    jp = jparams(d, jspec, jnp.float32 if spec_kw is FP16 else jnp.bfloat16)
    j = np.asarray(jmoe.moe_mlp(jnp.asarray(d["x"]), jp, jspec, jspec,
                                top_k=d["k"], **kw))
    with torch.inference_mode():
        t = tmoe.moe_mlp(torch.from_numpy(d["x"]), to_port(jp), tspec,
                         tspec, top_k=d["k"], **kw).numpy()
    return j, t


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("spec_kw", [W8A8, W8A16, FP16],
                         ids=["mix", "weight_only", "fp16"])
def test_expert_from_float_bit_equal(spec_kw):
    d = weights(0)
    j = jmoe.expert_from_float(jnp.asarray(d["w1"]), JSpec(**spec_kw))
    t = tmoe.expert_from_float(torch.from_numpy(d["w1"]), TSpec(**spec_kw))
    q = tensor_from_numpy(np.asarray(j.q_weight), "cpu")
    assert t.q_weight.dtype == q.dtype
    assert torch.equal(t.q_weight.view(torch.int16) if q.dtype
                       == torch.bfloat16 else t.q_weight,
                       q.view(torch.int16) if q.dtype == torch.bfloat16
                       else q)
    if j.w_scale is None:
        assert t.w_scale is None
    else:
        assert torch.equal(t.w_scale, tensor_from_numpy(
            np.asarray(j.w_scale), "cpu"))


@pytest.mark.parametrize("rows", [8, 13])
def test_expert_linear_w8a8_bit_equal(rows):
    """Kernel 2's expert mode (its plain version here) gives JAX's bits,
    zero sentinel rows included (a clamped scale, zero codes)."""
    rng = np.random.RandomState(rows)
    x = rng.randn(E, rows, H).astype(np.float32)
    x[1, 3:] = 0.0                               # sentinel rows
    xb = jnp.asarray(x, jnp.bfloat16)
    spec = JSpec(**W8A8)
    jw = jmoe.expert_from_float(jnp.asarray(rng.randn(E, H, I), jnp.float32)
                                * 0.1, spec)
    j = np.asarray(jmoe.expert_linear(jw, xb, spec))
    tw = tmoe.ExpertLinearParams(
        tensor_from_numpy(np.asarray(jw.q_weight), "cpu"),
        tensor_from_numpy(np.asarray(jw.w_scale), "cpu"))
    t = tmoe.expert_linear(tw, tensor_from_numpy(np.asarray(xb), "cpu"),
                           TSpec(**W8A8))
    assert t.dtype == torch.float32 and tuple(t.shape) == (E, rows, I)
    assert np.array_equal(t.numpy(), j)
    assert not t[1, 3:].any()


def test_expert_plain_is_exact():
    """mix_gemm_experts_plain against an int64 accumulator at the extreme
    codes (|acc| = 127 * 127 * K), in JAX's order of the scales."""
    g = torch.Generator().manual_seed(0)
    q_x = torch.randint(-127, 128, (3, 5, 256), generator=g).to(torch.int8)
    q_x[0, 0] = 127
    w = torch.randint(-127, 128, (3, 256, 32), generator=g).to(torch.int8)
    w[0, :, 0] = 127
    xs = torch.rand((3, 5, 1), generator=g) + 0.5
    ws = torch.rand((3, 32), generator=g) + 0.5
    acc = torch.bmm(q_x.long(), w.long())
    assert acc[0, 0, 0] == 127 * 127 * 256
    want = acc.float() * xs * ws[:, None, :]
    got = K.mix_gemm_experts(q_x, w, xs, ws)
    assert torch.equal(got, want)
    assert torch.equal(K.mix_gemm_experts_plain(q_x, w, xs, ws), want)


@pytest.mark.parametrize("spec_kw", [W8A16, FP16],
                         ids=["weight_only", "fp16"])
def test_expert_linear_close(spec_kw):
    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(E, 8, H), jnp.bfloat16)
    spec = JSpec(**spec_kw)
    jw = jmoe.expert_from_float(jnp.asarray(rng.randn(E, H, I), jnp.float32)
                                * 0.1, spec)
    j = np.asarray(jmoe.expert_linear(jw, x, spec))
    tw = tmoe.ExpertLinearParams(
        tensor_from_numpy(np.asarray(jw.q_weight), "cpu"),
        None if jw.w_scale is None else tensor_from_numpy(
            np.asarray(jw.w_scale), "cpu"))
    t = tmoe.expert_linear(tw, tensor_from_numpy(np.asarray(x), "cpu"),
                           TSpec(**spec_kw)).numpy()
    assert rel(t, j) < 1e-5


def _ref_moe(x, router, w1, w3, w2, k):
    """Per-token loop, HF MixtralSparseMoeBlock semantics (tests/
    test_moe.py::_ref_moe)."""
    out = np.zeros((x.shape[0] * x.shape[1], x.shape[2]), np.float64)
    for s, h in enumerate(x.reshape(-1, x.shape[-1]).astype(np.float64)):
        logits = h @ router
        p = np.exp(logits - logits.max())
        p /= p.sum()
        idx = np.argsort(-p, kind="stable")[:k]
        for e, wt in zip(idx, p[idx] / p[idx].sum()):
            g, u = h @ w1[e], h @ w3[e]
            out[s] += wt * ((g / (1 + np.exp(-g)) * u) @ w2[e])
    return out.reshape(x.shape)


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_mlp_exact_fp16(seed):
    """FP16 experts (f32 storage), exact capacity: JAX's within 1e-5 of
    max|y|, the per-token loop within 2e-4."""
    d = weights(seed)
    assert routing_gap(d["x"], d["router"], d["k"]) > MARGIN
    j, t = run_both(d, FP16)
    assert rel(t, j) < 1e-5
    ref = _ref_moe(d["x"], d["router"], d["w1"], d["w3"], d["w2"], d["k"])
    np.testing.assert_allclose(t, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_moe_mlp_exact_w8a8(seed):
    """W8A8 experts, exact capacity: JAX's within 1e-5 of max|y| (the
    expert products are bit-equal; the router's f32 sums and the combine
    differ by ulps), the loop within 5% of max|y| (int8)."""
    d = weights(seed)
    assert routing_gap(d["x"], d["router"], d["k"]) > MARGIN
    j, t = run_both(d, W8A8)
    assert rel(t, j) < 1e-5
    ref = _ref_moe(d["x"], d["router"], d["w1"], d["w3"], d["w2"], d["k"])
    assert rel(t, ref) < 0.05


@pytest.mark.parametrize("spec_kw", [W8A8, FP16], ids=["mix", "fp16"])
def test_moe_mlp_capacity_drops(spec_kw):
    """capacity_factor 1.0 (C = ceil(S k / E) = 5 of 10 tokens) drops the
    same choices as JAX's, and every token whose choices all fit equals
    the exact run's; a factor that never binds equals the exact run."""
    d = weights(3)
    assert routing_gap(d["x"], d["router"], d["k"]) > MARGIN
    j, t = run_both(d, spec_kw, capacity_factor=1.0)
    assert rel(t, j) < 1e-5
    _, exact = run_both(d, spec_kw)
    _, huge = run_both(d, spec_kw, capacity_factor=100.0)
    np.testing.assert_array_equal(huge, exact)
    # the kept tokens, from the routing bookkeeping in numpy
    S, k = B * T, d["k"]
    xs = d["x"].reshape(S, H)
    logits = xs @ d["router"]
    top_e = np.argsort(-logits, axis=-1, kind="stable")[:, :k]
    C = tmoe.moe_capacity(S, E, k, 1.0)
    fill, dropped = np.zeros(E, int), np.zeros((S, k), bool)
    for s in range(S):
        for c in range(k):
            dropped[s, c] = fill[top_e[s, c]] >= C
            fill[top_e[s, c]] += 1
    assert dropped.any() and not dropped.all()
    kept = ~dropped.any(axis=1)
    np.testing.assert_array_equal(t.reshape(S, H)[kept],
                                  exact.reshape(S, H)[kept])
    assert not np.array_equal(t.reshape(S, H)[~kept],
                              exact.reshape(S, H)[~kept])


def test_moe_mlp_shared_expert_mix():
    """qwen2-moe: top-4 of 4 experts without renormalisation, the shared
    expert's gate and up sharing one prepared activation with a planted
    outlier set (and down its own), sigmoid-gated: JAX's within 1e-5."""
    d = weights(10, k=3, shared=True)
    d["x"][:, :, 7] *= 30.0                      # an outlier channel,
    d["router"][7] = 0.0                         # which routes nothing
    assert routing_gap(d["x"], d["router"], d["k"]) > MARGIN
    jspec, tspec = JSpec(**W8A8), TSpec(**W8A8)
    osets = (JQ.outlier_set_from_indices(np.array([3, 7, 40]), H, 16),
             JQ.outlier_set_from_indices(np.array([1, 100]), 2 * I, 16))
    jp = jparams(d, jspec, osets=osets)
    assert jp.shared_up.w_outlier is not None
    j = np.asarray(jmoe.moe_mlp(jnp.asarray(d["x"]), jp, jspec, jspec,
                                top_k=d["k"], norm_topk=False))
    with torch.inference_mode():
        t = tmoe.moe_mlp(torch.from_numpy(d["x"]), to_port(jp), tspec, tspec,
                         top_k=d["k"], norm_topk=False).numpy()
    assert rel(t, j) < 1e-5
    # the shared expert moves the output
    no_shared = jp._replace(shared_up=None)
    j0 = np.asarray(jmoe.moe_mlp(jnp.asarray(d["x"]), no_shared, jspec,
                                 jspec, top_k=d["k"], norm_topk=False))
    assert rel(j0, j) > 1e-2


@pytest.mark.parametrize("spec_kw", [W8A8, FP16], ids=["mix", "fp16"])
def test_moe_mlp_zero_router_ties(spec_kw):
    """A zero router: every probability is 1/E, and both packages take
    experts 0..k-1 (jax.lax.top_k's order, ops/quant.py::top_indices), so
    the output equals the mean of those experts' outputs."""
    d = weights(6, k=2)
    d["router"][:] = 0.0
    j, t = run_both(d, spec_kw)
    assert rel(t, j) < 1e-5
    dd = dict(d, w1=d["w1"][:2], w3=d["w3"][:2], w2=d["w2"][:2],
              router=np.zeros((H, 2), np.float32))
    first_two = _ref_moe(dd["x"], dd["router"], dd["w1"], dd["w3"],
                         dd["w2"], 2)
    if spec_kw is FP16:
        np.testing.assert_allclose(t, first_two, rtol=2e-4, atol=2e-4)
    probs = torch.softmax(torch.zeros(3, E), -1)
    from mixq_tpu_torch.ops.quant import top_indices
    assert top_indices(probs, 2).tolist() == [[0, 1]] * 3


def test_expert_plan_counts_every_experts_tiles():
    """plan_mix with `experts` splits K only when E x tiles leave SMs
    idle: Mixtral's down projection (32 tiles an expert) splits for one
    expert on 132 SMs, not for eight (256 tiles); Qwen1.5-MoE's 60 experts
    never split; the grid is E x tiles x S blocks."""
    sm = 132
    one = K.plan_mix(8, 4096, 14336, False, 1, sm)
    eight = K.plan_mix(8, 4096, 14336, False, 1, sm, experts=8)
    assert one.splits > 1 and eight.splits == 1
    assert eight.blocks == 8 * 32
    qwen = K.plan_mix(8, 1408, 2048, False, 1, sm, experts=60)
    assert qwen.splits == 1 and qwen.blocks == 60 * 11
    assert K.plan_mix(8, 4096, 14336, False, 1, sm, experts=1) == one
