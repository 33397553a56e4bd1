"""MINPACK-style Levenberg-Marquardt with trust region (More 1978).

Behavioural equivalent of the optimizer the reference drives for
candidate refinement: ``Eigen::LevenbergMarquardt`` from
unsupported/NonLinearOptimization — itself a port of MINPACK ``lmder``
— with ``parameters.ftol/xtol`` and the ``maxfev`` function-evaluation
budget set in refine_candidate.cc:78-86.  The previous hand-rolled
lambda-schedule loop could rank near-tie candidates differently from
the reference because its damping trajectory (and therefore its
first few iterates under a 10-evaluation budget) was unrelated to the
trust-region algorithm; this module implements the published algorithm
(J. J. More, "The Levenberg-Marquardt algorithm: implementation and
theory", Lecture Notes in Mathematics 630, 1978) so the iterates match
MINPACK's to rounding.

Implementation notes (deliberate differences from the Fortran, none
behavioural): the trust-region subproblem ``lmpar`` uses a dense
column-pivoted QR (LAPACK via scipy) plus an augmented least-squares
solve and a Cholesky factorisation for the Newton derivative, instead
of MINPACK's hand-rolled qrfac/qrsolv Givens updates — at n=18
parameters the dense solves are exact to rounding and far simpler.
Verified against scipy's wrapped MINPACK ``lmder`` (scipy.optimize
.leastsq with Dfun) in tests/test_lm.py: identical minimisers, matching
evaluation counts, on full and truncated (maxfev=10) budgets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.linalg as sla

_EPS = np.finfo(np.float64).eps


@dataclass
class LMResult:
    x: np.ndarray
    fvec: np.ndarray
    cost: float  # ||fvec||^2
    nfev: int
    njev: int
    status: int  # MINPACK info: 1/2/3 converged, 4 gtol, 5 maxfev, 6..8 eps


def _lmpar(R, perm, diag, qtb, delta, par):
    """Solve the trust-region subproblem.

    Given J[:, perm] = Q R, diag scaling D, qtb = Q^T f and radius
    delta, find par >= 0 and the step p minimising
    ``||f + J p||^2 + par ||D p||^2`` such that either par == 0 and
    ||D p|| <= 1.1 delta, or ||D p|| is within 10% of delta
    (More 1978, algorithm 5.5).
    """
    n = len(qtb)
    s = diag[perm]  # D in permuted coordinates

    def damped_step(a):
        # min ||qtb + R z||^2 + a ||S z||^2 via the augmented system
        A = np.vstack([R, np.sqrt(a) * np.diag(s)]) if a > 0 else R
        b = np.concatenate([-qtb, np.zeros(n)]) if a > 0 else -qtb
        z, *_ = np.linalg.lstsq(A, b, rcond=None)
        return z

    # Gauss-Newton step (par = 0)
    z = damped_step(0.0)
    dxnorm = np.linalg.norm(s * z)
    fp = dxnorm - delta
    if fp <= 0.1 * delta:
        p = np.empty(n)
        p[perm] = z
        return 0.0, p, dxnorm

    # lower bound: nonzero only if R is nonsingular
    parl = 0.0
    rdiag = np.abs(np.diag(R))
    if rdiag.min() > 0:
        w = s * (s * z) / dxnorm
        y = sla.solve_triangular(R, w, trans="T")
        parl = fp / (delta * float(y @ y))
    # upper bound from the scaled gradient
    grad = R.T @ qtb
    gnorm = float(np.linalg.norm(grad / np.where(s > 0, s, 1.0)))
    paru = gnorm / delta
    if paru == 0.0:
        paru = np.finfo(np.float64).tiny / min(delta, 0.1)

    # lmpar.f: clamp the incoming par to [parl, paru]; a zero start
    # (routine here — frozen parameters zero Jacobian columns, so
    # parl == 0) is seeded from the scaled gradient over the
    # Gauss-Newton step norm, NOT an arbitrary fraction of paru
    par = min(max(par, parl), paru)
    if par == 0.0:
        par = gnorm / dxnorm

    for itn in range(1, 11):
        if par == 0.0:  # lmpar.f loop-top guard (p001 = 0.001)
            par = max(np.finfo(np.float64).tiny, 1e-3 * paru)
        z = damped_step(par)
        u = s * z
        dxnorm = np.linalg.norm(u)
        fp_old = fp
        fp = dxnorm - delta
        # accept par: small residual, the exceptional parl == 0 case,
        # or iteration 10 — checked BEFORE the Newton update so the
        # returned (par, step) pair is always consistent (lmpar.f:220)
        if (
            abs(fp) <= 0.1 * delta
            or (parl == 0.0 and fp <= fp_old and fp_old < 0.0)
            or itn == 10
        ):
            break
        # Newton correction on the reciprocal-scaled phi (More eq. 5.6):
        # parc = fp / (delta * v^T M^-1 v), M = R^T R + par S^2
        v = s * u / dxnorm
        M = R.T @ R + par * np.diag(s * s)
        try:
            L = np.linalg.cholesky(M)
            y = sla.solve_triangular(L, v, lower=True)
            parc = fp / (delta * float(y @ y))
        except np.linalg.LinAlgError:
            break
        if fp > 0:
            parl = max(parl, par)
        elif fp < 0:
            paru = min(paru, par)
        par = max(parl, par + parc)

    p = np.empty(n)
    p[perm] = z
    return par, p, dxnorm


def lmder(fn, jac, x0, ftol=1e-6, xtol=1e-6, gtol=0.0, maxfev=10,
          factor=100.0):
    """Minimise ``||fn(x)||^2`` with analytic Jacobian ``jac``.

    Mirrors MINPACK lmder / Eigen LevenbergMarquardt::minimize semantics:
    diagonal scaling from Jacobian column norms (mode 1, monotonically
    non-decreasing), trust radius ``factor * ||D x0||``, the 0.25/0.75
    ratio radius update, step acceptance at ratio >= 1e-4, convergence
    tests on relative cost reduction (ftol), scaled step (xtol) and
    scaled gradient (gtol), and termination once ``nfev >= maxfev``.
    """
    x = np.asarray(x0, dtype=np.float64).copy()
    fvec = np.asarray(fn(x), dtype=np.float64)
    nfev, njev = 1, 0
    fnorm = np.linalg.norm(fvec)
    par, delta, xnorm, diag = 0.0, 0.0, 0.0, None
    status = 0
    it = 1

    while status == 0:
        J = np.asarray(jac(x), dtype=np.float64)
        njev += 1
        acnorm = np.linalg.norm(J, axis=0)
        Q, R, perm = sla.qr(J, mode="economic", pivoting=True)
        if it == 1:
            diag = np.where(acnorm == 0.0, 1.0, acnorm)
            xnorm = np.linalg.norm(diag * x)
            delta = factor * xnorm if xnorm > 0 else factor
        else:
            diag = np.maximum(diag, acnorm)
        qtf = Q.T @ fvec

        gnorm = 0.0
        if fnorm != 0.0:
            g = J.T @ fvec
            nz = acnorm > 0
            if nz.any():
                gnorm = float(np.max(np.abs(g[nz]) / (fnorm * acnorm[nz])))
        if gnorm <= gtol:
            status = 4
            break

        while True:  # inner: shrink the radius until a successful step
            par, p, _ = _lmpar(R, perm, diag, qtf, delta, par)
            pnorm = np.linalg.norm(diag * p)
            if it == 1:
                delta = min(delta, pnorm)

            fvec_new = np.asarray(fn(x + p), dtype=np.float64)
            nfev += 1
            fnorm1 = np.linalg.norm(fvec_new)

            actred = -1.0
            if 0.1 * fnorm1 < fnorm:
                actred = 1.0 - (fnorm1 / fnorm) ** 2
            temp1 = np.linalg.norm(J @ p) / fnorm
            temp2 = np.sqrt(par) * pnorm / fnorm
            prered = temp1**2 + 2.0 * temp2**2
            dirder = -(temp1**2 + temp2**2)
            ratio = actred / prered if prered > 0 else 0.0

            if ratio <= 0.25:
                temp = 0.5 if actred >= 0 else 0.5 * dirder / (
                    dirder + 0.5 * actred
                )
                if 0.1 * fnorm1 >= fnorm or temp < 0.1:
                    temp = 0.1
                delta = temp * min(delta, pnorm / 0.1)
                par /= temp
            elif par == 0.0 or ratio >= 0.75:
                delta = 2.0 * pnorm
                par *= 0.5

            if ratio >= 1e-4:  # successful iteration
                x = x + p
                fvec, fnorm = fvec_new, fnorm1
                xnorm = np.linalg.norm(diag * x)
                it += 1

            if (
                abs(actred) <= ftol
                and prered <= ftol
                and 0.5 * ratio <= 1.0
            ):
                status = 1
            if delta <= xtol * xnorm:
                status = 2 if status == 0 else 3
            if status != 0:
                break
            if nfev >= maxfev:
                status = 5
                break
            if (
                abs(actred) <= _EPS
                and prered <= _EPS
                and 0.5 * ratio <= 1.0
            ):
                status = 6
                break
            if delta <= _EPS * xnorm:
                status = 7
                break
            if gnorm <= _EPS:
                status = 8
                break
            if ratio >= 1e-4:
                break  # go recompute the Jacobian

    return LMResult(
        x=x, fvec=fvec, cost=float(fnorm**2), nfev=nfev, njev=njev,
        status=status,
    )
