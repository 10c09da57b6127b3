"""PyTorch port, the continuous-batching sampler
(mixq_tpu_torch/engine/sampling.py::sample_per_slot) against JAX's
(mixq_tpu/engine/sampling.py::sample_per_slot).

The two draw from different random bits (the port by Gumbel-max from a
torch.Generator), so sampled rows are compared by their support: over a few
thousand draws of rows with tied logits (V=16), the set of tokens either
side can emit is the same, which pins the tie rule of top-k (exactly k
entries by rank, ties by the lower index) and the top-p cutoff. Greedy rows
are compared token for token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixq_tpu.engine.sampling import sample_per_slot as j_sample_per_slot
from mixq_tpu_torch.engine.sampling import sample_per_slot

DRAWS = 4000


def _rows(B, temperature, top_k, top_p):
    return (torch.full((B,), temperature, dtype=torch.float32),
            torch.full((B,), top_k, dtype=torch.int32),
            torch.full((B,), top_p, dtype=torch.float32))


def test_greedy_rows_are_argmax():
    logits = torch.from_numpy(
        np.random.default_rng(0).normal(size=(6, 64)).astype(np.float32) * 3)
    gen = torch.Generator().manual_seed(0)
    want = torch.argmax(logits, dim=-1).to(torch.int32)
    t, k, p = _rows(6, 0.0, 0, 1.0)
    # all greedy, with and without the sampling step
    assert torch.equal(sample_per_slot(logits, gen, t, k, p, False), want)
    assert torch.equal(sample_per_slot(logits, gen, t, k, p, True), want)
    # greedy rows beside sampled ones
    t[1::2] = 1.5
    got = sample_per_slot(logits, gen, t, k, p, True)
    assert torch.equal(got[0::2], want[0::2])
    jgot = j_sample_per_slot(jnp.asarray(logits.numpy()),
                             jax.random.PRNGKey(0), jnp.asarray(t.numpy()),
                             jnp.asarray(k.numpy()), jnp.asarray(p.numpy()))
    assert (np.asarray(jgot)[0::2] == want.numpy()[0::2]).all()


def test_all_greedy_step_draws_nothing():
    logits = torch.randn(3, 32, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    sample_per_slot(logits, gen, *_rows(3, 0.0, 0, 1.0), sampled=False)
    assert torch.equal(gen.get_state(), state)


def test_top_k_one_is_greedy():
    logits = torch.randn(3, 32, generator=torch.Generator().manual_seed(2)) * 5
    out = sample_per_slot(logits, torch.Generator().manual_seed(3),
                          *_rows(3, 1.0, 1, 1.0))
    assert torch.equal(out, torch.argmax(logits, dim=-1).to(torch.int32))


# rows of V=16 logits with ties at the cut: top-k keeps the lower indices
# of the tied entries; top-p's cutoff value keeps every entry equal to it
TIED = np.array([1.0, 3.0, 2.0, 3.0, 3.0, 0.5, 2.0, 2.0,
                 -1.0, 3.0, 0.0, 2.0, 1.0, -2.0, 0.0, 1.0], np.float32)


@pytest.mark.parametrize("temperature,top_k,top_p,support", [
    (1.0, 2, 1.0, {1, 3}),                    # 4 tied at 3.0: first 2 kept
    (0.7, 5, 1.0, {1, 3, 4, 9, 2}),           # the 4 threes + one 2.0
    (1.0, 0, 0.5, {1, 3, 4, 9}),              # top-p cut inside the threes
    (2.0, 6, 0.8, {1, 3, 4, 9, 2, 6}),        # top-k, then top-p over it
])
def test_support_at_ties_equals_jax(temperature, top_k, top_p, support):
    logits = np.tile(TIED, (DRAWS, 1))
    t, k, p = _rows(DRAWS, temperature, top_k, top_p)
    got = sample_per_slot(torch.from_numpy(logits),
                          torch.Generator().manual_seed(7), t, k, p)
    ref = j_sample_per_slot(jnp.asarray(logits), jax.random.PRNGKey(7),
                            jnp.asarray(t.numpy()), jnp.asarray(k.numpy()),
                            jnp.asarray(p.numpy()))
    port_set = set(got.tolist())
    jax_set = set(np.asarray(ref).tolist())
    # the rule itself, not only agreement: at top_k = 5 the fifth entry
    # is the first 2.0 by index (2), at top_k = 6 the second (6)
    assert port_set == jax_set == support


def test_per_row_parameters():
    """Rows of one call take their own parameters: a top_k = 1 row is the
    argmax, a top_k = 2 row stays in its two largest."""
    logits = np.tile(TIED, (DRAWS, 1))
    t = torch.full((DRAWS,), 1.0)
    k = torch.tensor([1, 2] * (DRAWS // 2), dtype=torch.int32)
    p = torch.ones((DRAWS,))
    got = sample_per_slot(torch.from_numpy(logits),
                          torch.Generator().manual_seed(9), t, k, p)
    assert set(got[0::2].tolist()) == {1}
    assert set(got[1::2].tolist()) == {1, 3}
