"""PyTorch port: the online outlier predictor's pieces against
mixq_tpu/ops: `detect_new_outliers(_from_absmax)` gives count, ind, mask
and k_mask bit-equal to JAX's (an empty set, a partial set, a budget
overflow among tied maxima, nothing new); `promote_outliers` from an empty
set (warmup's first promotion) gives every field bit-equal to JAX's, on
W8 and packed W4, from the dequantized int weight and from the fp weight.

Two documented differences from JAX, each asserted as such:
- a second promotion without the fp weight: JAX regathers every slot from
  the int weight, whose rows of the earlier promotion are already zero, so
  it loses those w_outlier rows; the port keeps them. The new rows, the int
  weight and the set are bit-equal to JAX's;
- grouped [G, N] scales: JAX's dequantization does not broadcast and
  raises ValueError; the port raises ValueError with its own message."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.ops import quant as JQ
from mixq_tpu.ops.mixed_linear import LinearSpec as JSpec
from mixq_tpu.ops.mixed_linear import from_float as j_from_float
from mixq_tpu.ops.mixed_linear import promote_outliers as j_promote
from mixq_tpu_torch.ops import quant as TQ
from mixq_tpu_torch.ops.mixed_linear import LinearSpec as TSpec
from mixq_tpu_torch.ops.mixed_linear import from_float as t_from_float
from mixq_tpu_torch.ops.mixed_linear import promote_outliers as t_promote

K, BUDGET, SIGMA = 64, 8, 6.0


def t(a):
    return torch.from_numpy(np.asarray(a).copy())


def assert_same(j, p, what=""):
    """Same dtype, shape and bits (bf16 compared through exact f32)."""
    j = np.asarray(j)
    if p.dtype == torch.bfloat16:
        assert j.dtype.name == "bfloat16", (what, j.dtype)
        j, p = j.astype(np.float32), p.float().numpy()
    else:
        p = p.numpy()
        assert j.dtype == p.dtype, (what, j.dtype, p.dtype)
    assert j.shape == p.shape, (what, j.shape, p.shape)
    np.testing.assert_array_equal(j, p, err_msg=what)


def assert_same_set(js, ts):
    for f in JQ.OutlierSet._fields:
        assert_same(getattr(js, f), getattr(ts, f), f)


def start_set(kind):
    """(JAX set, port set) before detection."""
    if kind == "empty":
        return (JQ.empty_outlier_set(K, BUDGET),
                TQ.empty_outlier_set(K, BUDGET, device="cpu"))
    ind = np.array([40, 3, 17], np.int32) if kind == "partial" else \
        np.arange(BUDGET, dtype=np.int32) * 5
    return (JQ.outlier_set_from_indices(ind, K, BUDGET),
            TQ.outlier_set_from_indices(ind, K, BUDGET, device="cpu"))


def channel_max(case, seed):
    """Per-channel maxima: "some" (a few past sigma), "ties" (more past
    sigma than the budget holds, on tied values), "none" (none past)."""
    rng = np.random.default_rng(seed)
    m = rng.uniform(0.0, 5.0, K).astype(np.float32)
    if case == "some":
        m[rng.choice(K, 4, replace=False)] = rng.uniform(7, 20, 4)
    elif case == "ties":
        m[rng.choice(K, 20, replace=False)] = rng.integers(7, 10, 20)
    return m.astype(np.float32)


@pytest.mark.parametrize("start", ["empty", "partial", "full"])
@pytest.mark.parametrize("case", ["some", "ties", "none"])
@pytest.mark.parametrize("seed", [0, 1])
def test_detect_from_absmax_as_jax(start, case, seed):
    js, ts = start_set(start)
    m = channel_max(case, seed)
    if start == "partial":            # the set's own channels stay out
        m[[40, 3, 17]] = 30.0
    jn = JQ.detect_new_outliers_from_absmax(jnp.asarray(m), js, SIGMA)
    tn = TQ.detect_new_outliers_from_absmax(t(m), ts, SIGMA)
    assert_same_set(jn, tn)
    # sticky: the set's live entries keep their slots
    n0 = int(ts.count)
    assert tn.ind[:n0].tolist() == ts.ind[:n0].tolist()
    assert int(tn.count) <= BUDGET
    if case == "none" or start == "full":
        assert int(tn.count) == n0


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_from_activations_as_jax(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 5, K)).astype(np.float32)
    x[1, 3, [9, 30, 31]] = [-12.0, 8.0, 8.0]
    js, ts = start_set("partial")
    assert_same_set(JQ.detect_new_outliers(jnp.asarray(x), js, SIGMA),
                    TQ.detect_new_outliers(t(x), ts, SIGMA))


def linear(w_bit, seed, N=32):
    """(JAX params, port params, JAX spec, port spec, fp weight [K, N])
    quantized with an empty, budget-reserved set."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((K, N)) * 0.05).astype(np.float32)
    js_, ts_ = JSpec(w_bit=w_bit, a_bit=w_bit), TSpec(w_bit=w_bit,
                                                      a_bit=w_bit)
    jo, to = start_set("empty")
    jp = j_from_float(jnp.asarray(w), js_, outlier_set=jo)
    tp = t_from_float(t(w), ts_, outlier_set=to)
    assert_same(jp.q_weight, tp.q_weight)
    return jp, tp, js_, ts_, w


def assert_same_params(jp, tp, skip=()):
    for f in ("q_weight", "w_scale", "w_outlier", "out_ind", "out_mask",
              "k_mask", "out_count"):
        if f not in skip:
            assert_same(getattr(jp, f), getattr(tp, f), f)


@pytest.mark.parametrize("w_bit", [8, 4])
@pytest.mark.parametrize("from_fp", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_first_promotion_as_jax(w_bit, from_fp, seed):
    jp, tp, js_, ts_, w = linear(w_bit, seed)
    if w_bit == 4:
        assert tp.q_weight.dtype == torch.uint8        # packed halves
    m = channel_max("some", seed)
    jn = JQ.detect_new_outliers_from_absmax(jnp.asarray(m),
                                            jp.outlier_set, SIGMA)
    tn = TQ.detect_new_outliers_from_absmax(t(m), tp.outlier_set, SIGMA)
    j2 = j_promote(jp, jnp.asarray(w) if from_fp else None, jn, js_)
    t2 = t_promote(tp, t(w) if from_fp else None, tn, ts_)
    assert_same_params(j2, t2)
    # the promoted rows are zero in the int weight and live in w_outlier
    n = int(t2.out_count)
    assert n == 4
    rows = t2.out_ind[:n].long()
    qi = TQ.unpack_int4(t2.q_weight) if w_bit == 4 else t2.q_weight
    assert (qi[rows] == 0).all()
    assert (t2.w_outlier[:n] != 0).any(dim=1).all()


@pytest.mark.parametrize("w_bit", [8, 4])
def test_second_promotion_keeps_earlier_rows(w_bit):
    jp, tp, js_, ts_, _ = linear(w_bit, 3)
    steps = []
    for m in (channel_max("some", 3), channel_max("some", 4)):
        jn = JQ.detect_new_outliers_from_absmax(jnp.asarray(m),
                                                jp.outlier_set, SIGMA)
        tn = TQ.detect_new_outliers_from_absmax(t(m), tp.outlier_set, SIGMA)
        assert_same_set(jn, tn)
        before = tp
        jp, tp = j_promote(jp, None, jn, js_), t_promote(tp, None, tn, ts_)
        steps.append((before, int(before.out_count), int(tn.count)))
    before, n0, n1 = steps[1]
    assert 0 < n0 < n1
    assert_same_params(jp, tp, skip=("w_outlier",))
    jw = np.asarray(jp.w_outlier).astype(np.float32)
    tw = tp.w_outlier.float().numpy()
    # the new rows as JAX's; the earlier ones kept (JAX's are zeros)
    np.testing.assert_array_equal(jw[n0:], tw[n0:])
    np.testing.assert_array_equal(tw[:n0],
                                  before.w_outlier[:n0].float().numpy())
    assert (tw[:n0] != 0).any(axis=1).all()
    assert (jw[:n0] == 0).all()


@pytest.mark.parametrize("group_size", [32, 64])
def test_grouped_promotion_raises_as_jax(group_size):
    rng = np.random.default_rng(5)
    w = (rng.standard_normal((K, 32)) * 0.05).astype(np.float32)
    js_ = JSpec(w_bit=8, a_bit=8, group_size=group_size)
    ts_ = TSpec(w_bit=8, a_bit=8, group_size=group_size)
    jo, to = start_set("empty")
    jp = j_from_float(jnp.asarray(w), js_, outlier_set=jo)
    tp = t_from_float(t(w), ts_, outlier_set=to)
    m = channel_max("some", 5)
    jn = JQ.detect_new_outliers_from_absmax(jnp.asarray(m), jo, SIGMA)
    tn = TQ.detect_new_outliers_from_absmax(t(m), to, SIGMA)
    with pytest.raises(ValueError):
        j_promote(jp, None, jn, js_)
    with pytest.raises(ValueError, match="grouped"):
        t_promote(tp, None, tn, ts_)
    # with the fp weight both gather the rows from it
    assert_same_params(j_promote(jp, jnp.asarray(w), jn, js_),
                       t_promote(tp, t(w), tn, ts_))
