"""`abip_tpu_torch.adaptive.bb_update_beta` against `abip_tpu.adaptive`.

Both run the Barzilai-Borwein trials through their own package's LP
workspace (dense Cholesky, f64) on the same numpy-seeded state.  The
spectral estimates divide inner products of differences of nearly equal
trial iterates, which amplifies rounding: the betas must agree to 1e-8
relative (measured: 1e-12 on the dense path)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from abip_tpu import lp as jlp  # noqa: E402
from abip_tpu.settings import Settings as JSettings  # noqa: E402
from abip_tpu_torch import lp  # noqa: E402
from abip_tpu_torch.settings import Settings  # noqa: E402
from bench import reference_smoke_lp  # noqa: E402


@pytest.fixture(scope="module")
def workspaces():
    A, b, c = reference_smoke_lp(m=12, n_rand=60, seed=7)
    return (jlp.LPWorkspace(A, b, c, JSettings(eps=1e-6)),
            lp.LPWorkspace(A, b, c, Settings(eps=1e-6), device="cpu"))


def _state(m, n, seed):
    if seed is None:                     # the all-zero state
        return np.zeros(m + n + 1), np.zeros(m + n + 1)
    rng = np.random.default_rng(seed)
    u = np.concatenate([rng.standard_normal(m), rng.random(n + 1) + 0.2])
    v = np.concatenate([np.zeros(m), rng.random(n + 1) * 0.5 + 0.05])
    return u, v


@pytest.mark.parametrize("seed,mu", [(0, 1.0), (1, 0.1), (2, 1e-3),
                                     (None, 1.0)])
@pytest.mark.parametrize("lookback", [1, 20])
def test_bb_beta_matches_reference(workspaces, seed, mu, lookback):
    jw, pw = workspaces
    u, v = _state(pw.m, pw.n, seed)
    stgs = dataclasses.replace(pw.stgs, adaptive_lookback=lookback)
    jstgs = dataclasses.replace(jw.stgs, adaptive_lookback=lookback)
    ref = float(jlp._bb_beta_k(jw.ops, jnp.asarray(u), jnp.asarray(v),
                               jnp.asarray(mu), stgs=jstgs))
    port = lp._bb_beta_k(pw.ops, torch.as_tensor(u), torch.as_tensor(v),
                         torch.tensor(mu, dtype=torch.float64), stgs=stgs)
    assert port.shape == () and port.dtype == torch.float64
    assert float(port) > 0
    assert float(port) == pytest.approx(ref, rel=1e-8)
