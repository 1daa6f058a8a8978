"""Concentration bounds for RCPS calibration.

Counterpart of the reference's numerics/bounds layer (reference:
core/calibration/bounds.py:6-42 — ``hoeffding_plus``/``bentkus_plus``/
``HB_mu_plus``/``WSR_mu_plus``). The bounds operate on host-side scalars (the
per-λ empirical risks), where exactness matters and FLOPs do not, so we keep
scipy's ``brentq``/``binom`` (exact-parity-safe) rather than approximating on
the device. A vectorized grid variant is provided so the full λ-grid can be bounded
in one call.

The port's copy of ``im2im_uq_tpu/calibration/bounds.py`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import brentq
from scipy.stats import binom

__all__ = [
    "hb_log_tail",
    "HB_mu_plus",
    "hb_mu_plus_grid",
    "WSR_mu_plus",
]

_EDGE = 1.0 - 1e-10


def _bernoulli_kl(a: float, b: float) -> float:
    """KL(Bern(a) || Bern(b)) without guards (NaN at the edges, like the
    reference's h1 — calibration's muhat=0 fallback depends on that)."""
    a, b = np.float64(a), np.float64(b)
    with np.errstate(divide="ignore", invalid="ignore"):
        return a * np.log(a / b) + (1.0 - a) * np.log((1.0 - a) / (1.0 - b))


def hb_log_tail(mu: float, muhat: float, n: int) -> float:
    """log P(empirical mean <= muhat) bound, Hoeffding-Bentkus hybridized.

    Mirrors min(hoeffding_plus, bentkus_plus) from the reference
    (core/calibration/bounds.py:10-14): the Hoeffding-KL tail
    ``-n * KL(min(mu, muhat) || mu)`` against the Bentkus binomial tail
    ``log(Binom(n, mu).cdf(floor(n * muhat))) + 1``.
    """
    hoeff = -n * _bernoulli_kl(min(mu, muhat), mu)
    bent = np.log(max(binom.cdf(np.floor(n * muhat), n, mu), 1e-10)) + 1.0
    return min(hoeff, bent)


def HB_mu_plus(muhat: float, n: int, delta: float, maxiters: int = 1000) -> float:
    """Upper confidence bound for a bounded mean via Hoeffding-Bentkus.

    Same contract as the reference ``HB_mu_plus`` (core/calibration/
    bounds.py:17-29): root-find the smallest mu whose log-tail at ``muhat``
    equals log(delta); returns 1.0 when no such mu exists below 1, or when
    the root-finder fails.
    """
    muhat = float(muhat)

    def _objective(mu: float) -> float:
        return hb_log_tail(mu, muhat, n) - np.log(delta)

    if _objective(_EDGE) > 0.0:
        return 1.0
    try:
        return float(brentq(_objective, muhat, _EDGE, maxiter=maxiters))
    except (ValueError, RuntimeError, ZeroDivisionError):
        return 1.0


def hb_mu_plus_grid(muhats: np.ndarray, n: int, delta: float) -> np.ndarray:
    """Vectorized HB UCB over a vector of empirical risks (one per λ).

    Convenience for bounding the whole λ grid at once (the reference calls
    HB_mu_plus one scalar at a time inside its calibration loop,
    core/calibration/calibrate_model.py:138).
    """
    return np.asarray([HB_mu_plus(m, n, delta) for m in np.asarray(muhats).ravel()])


def WSR_mu_plus(x: np.ndarray, delta: float, maxiters: int = 1000) -> float:
    """Waudby-Smith–Ramdas betting-martingale UCB of the mean of x ∈ [0,1]^n.

    Same estimator as the reference ``WSR_mu_plus`` (core/calibration/
    bounds.py:31-42): predictable plug-in mean/variance sequences, capped
    bets nu, and a root-find on the max of the log-capital process.
    """
    x = np.asarray(x, dtype=np.float64).ravel()
    n = x.shape[0]
    t = 1.0 + np.arange(1, n + 1)
    muhat = (np.cumsum(x) + 0.5) / t
    sig2 = (np.cumsum((x - muhat) ** 2) + 0.25) / t
    # Shift so each bet only uses strictly-past data; first bet uses the prior.
    sig2 = np.concatenate([[0.25], sig2[:-1]])
    nu = np.minimum(np.sqrt(2.0 * np.log(1.0 / delta) / (n * sig2)), 1.0)

    def _log_capital_minus_thresh(mu: float) -> float:
        return np.max(np.cumsum(np.log(1.0 - nu * (x - mu)))) + np.log(delta)

    if _log_capital_minus_thresh(1.0) < 0.0:
        return 1.0
    return float(brentq(_log_capital_minus_thresh, 1e-10, _EDGE, maxiter=maxiters))
