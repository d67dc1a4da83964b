"""Plots of a fitted model: the fitted curve or surface, residuals, the CV
curve.

Counterpart of ``multivartv_tpu/plotting.py``, after the reference's
plotting layers: plot.mvtv's 1-D line and 2-D surface with the fit between
two lambdas of the path interpolated (MultivarTV.R:90-146, 103-114),
plotResiduals with a LOESS trend (MultivarTV.R:69-79), and the CV curve.
Each function returns the matplotlib figure.  matplotlib is imported when
a plot is drawn, never when the package is imported; the card's machine
has none, so plots are drawn where a fit's host arrays are.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _require_mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _model_at_lambda(model, lam: Optional[float]):
    """(theta_hat in reference order, fitted) at lambda lam: the path's
    entry there, the mean of its two neighbours between two entries
    (MultivarTV.R:103-114), the end entries outside the grid; lam None: the
    best lambda's fit."""
    if lam is None:
        return model.theta_hat, model.fitted
    lams = np.asarray(model.lambdas)   # descending
    entries = model.models
    if not entries or "theta_hat" not in entries[0]:
        from multivartv_tpu_torch.utils.logging import get_logger
        get_logger().warning(
            "plot at lambda=%g requested but per-lambda fits were not stored "
            "(PathConfig.store != 'fitted' or the auto-degrade path); falling back to the "
            "best-lambda fit (lambda=%g)", lam, model.lambda_minmse)
        return model.theta_hat, model.fitted
    if lam >= lams[0]:
        e = entries[0]
        return e["theta_hat"], e["fitted"]
    if lam <= lams[-1]:
        e = entries[-1]
        return e["theta_hat"], e["fitted"]
    hi = int(np.searchsorted(-lams, -lam, side="left"))
    lo = hi - 1
    if np.isclose(lams[hi], lam):
        e = entries[hi]
        return e["theta_hat"], e["fitted"]
    th = 0.5 * (entries[lo]["theta_hat"] + entries[hi]["theta_hat"])
    ft = 0.5 * (entries[lo]["fitted"] + entries[hi]["fitted"])
    return th, ft


def _fit_at(model, theta_lat: torch.Tensor, pts: np.ndarray) -> np.ndarray:
    """The fitted values of points (k, p) on the model's mesh."""
    from multivartv_tpu_torch.ops import interp as interp_ops
    idx = interp_ops.flat_knot_indices(
        model.mesh_spec, torch.as_tensor(pts, dtype=torch.float32, device=theta_lat.device))
    return interp_ops.gather_fitted(theta_lat, idx).cpu().numpy()


def plot_model(model, lam: Optional[float] = None, addmesh: bool = False,
               adddata: bool = True, grid_mult: int = 3, save: Optional[str] = None):
    """The 1-D step function or the 2-D fitted surface (plot.mvtv); p > 2
    raises ValueError (MultivarTV.R:144)."""
    from multivartv_tpu_torch import mesh as mesh_lib
    plt = _require_mpl()
    p = model.data.shape[1]
    theta_flat, _ = _model_at_lambda(model, lam)
    dev = model.mesh_spec.deltas.device
    theta_lat = mesh_lib.unflatten_ref_order(
        torch.as_tensor(np.asarray(theta_flat), dtype=torch.float32, device=dev), model.m)

    if p == 1:
        fig, ax = plt.subplots(figsize=(7, 4.5))
        xs = np.linspace(model.mesh[:, 0].min(), model.mesh[:, 0].max(),
                         max(len(model.y) * 10, 500))
        ax.plot(xs, _fit_at(model, theta_lat, xs[:, None]), lw=2, label="fitted")
        if adddata:
            ax.plot(model.data[:, 0], model.y, ".", ms=3, alpha=0.6, label="data")
        if addmesh:
            knots = model.mesh_spec.knots[0].cpu().numpy()
            for v in knots[:-1] + np.diff(knots) / 2:
                ax.axvline(v, color="grey", lw=0.5, ls="--", alpha=0.5)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        ax.legend()
    elif p == 2:
        fig = plt.figure(figsize=(8, 6))
        ax = fig.add_subplot(111, projection="3d")
        new_m = int(np.floor(np.sqrt(len(model.y)))) * grid_mult
        x1 = np.linspace(model.mesh[:, 0].min(), model.mesh[:, 0].max(), new_m)
        x2 = np.linspace(model.mesh[:, 1].min(), model.mesh[:, 1].max(), new_m)
        g1, g2 = np.meshgrid(x1, x2)
        pts = np.stack([g1.reshape(-1), g2.reshape(-1)], 1)
        z = _fit_at(model, theta_lat, pts).reshape(new_m, new_m)
        ax.plot_surface(g1, g2, z, cmap="viridis", alpha=0.85)
        if adddata:
            ax.scatter(model.data[:, 0], model.data[:, 1], model.y, s=3, c="k", alpha=0.4)
        ax.set_xlabel("x1")
        ax.set_ylabel("x2")
        ax.set_zlabel("y")
    else:
        raise ValueError("Only univariate and bivariate plotting supported.")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def _loess_smooth(x_sorted, y_sorted, frac=0.75, degree=2):
    """The LOESS trend of R's stats::loess with its defaults (span 0.75,
    degree 2; MultivarTV.R:74): at each point a tricube-weighted local
    polynomial over the span's nearest neighbours, no robustifying pass.
    x must be sorted."""
    x = np.asarray(x_sorted, np.float64)
    y = np.asarray(y_sorted, np.float64)
    n = len(x)
    k = max(degree + 1, min(n, int(np.ceil(frac * n))))
    out = np.empty(n)
    for i in range(n):
        # Among the k-point windows that hold i, the one whose farthest
        # end is nearest (loess's span-nearest neighbourhood).
        best_a, best_d = None, np.inf
        for a in range(max(0, i - k + 1), min(i, n - k) + 1):
            dmax_a = max(x[i] - x[a], x[a + k - 1] - x[i])
            if dmax_a < best_d:
                best_a, best_d = a, dmax_a
        xs = x[best_a:best_a + k]
        ys = y[best_a:best_a + k]
        d = np.abs(xs - x[i])
        dmax = d.max()
        w = (1.0 - (d / dmax) ** 3) ** 3 if dmax > 0 else np.ones_like(d)
        cols = [np.ones_like(xs)] + [(xs - x[i]) ** q for q in range(1, degree + 1)]
        # Weighted least squares: both sides scaled by sqrt(w).
        sw = np.sqrt(w)
        beta, *_ = np.linalg.lstsq(np.stack(cols, 1) * sw[:, None], ys * sw, rcond=None)
        out[i] = beta[0]
    return out


def plot_residuals(model, save: Optional[str] = None):
    """Residuals against fitted values with a LOESS trend (plotResiduals)."""
    plt = _require_mpl()
    order = np.argsort(model.fitted)
    fit_srt = model.fitted[order]
    res_srt = model.residuals[order]
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(fit_srt, res_srt, "o", ms=3, alpha=0.5)
    ax.plot(fit_srt, _loess_smooth(fit_srt, res_srt), lw=1.5)
    ax.axhline(0.0, ls="--", lw=1, color="k")
    ax.set_xlabel("Fitted")
    ax.set_ylabel("Residuals")
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig


def plot_cv_curve(model, save: Optional[str] = None):
    """The CV MSE against lambda, with lambda.minmse and lambda.1se marked."""
    plt = _require_mpl()
    fig, ax = plt.subplots(figsize=(7, 4.5))
    ax.semilogx(model.lambdas, model.cv_mses, "-o", ms=3)
    ax.axvline(model.lambda_minmse, color="tab:green", ls="--", lw=1, label="lambda.minmse")
    ax.axvline(model.lambda_1se, color="tab:orange", ls="--", lw=1, label="lambda.1se")
    ax.set_xlabel("lambda")
    ax.set_ylabel("CV MSE")
    ax.legend()
    if save:
        fig.savefig(save, dpi=120, bbox_inches="tight")
    return fig
