"""The per-pixel coupled Jacobi update in T-form (tpuflow/ops/sweep_core.py:45-79).

Plain expression builders on tensors, in the JAX package's association
order; ``jacobi_sweep_plain`` uses them, and the CUDA sweep kernel
(csrc/level.cu) writes the same expressions per pixel:

    sumU   = sum_i pw_i (T_i - u_c)
    new_du = (-a13 - a12 * dv_c + sumU) / dnu
    new_dv = (-a23 - a12 * new_du + sumV) / dnv   (fresh du)
"""

from __future__ import annotations


def smoothness_sum(pw, nb, center):
    """sum_i pw_i * (nb_i - center), left-associated; pw and nb in the
    order (xp, xm, yp, ym)."""
    pw_xp, pw_xm, pw_yp, pw_ym = pw
    n_xp, n_xm, n_yp, n_ym = nb
    return (
        pw_xp * (n_xp - center)
        + pw_xm * (n_xm - center)
        + pw_yp * (n_yp - center)
        + pw_ym * (n_ym - center)
    )


def sweep_update_T(nb_tu, nb_tv, u_c, v_c, dv_c, pw, a12, a13, a23, dnu, dnv):
    """(new_du, new_dv) displacements; the caller stores T' = u + new_d."""
    sum_u = smoothness_sum(pw, nb_tu, u_c)
    sum_v = smoothness_sum(pw, nb_tv, v_c)
    new_du = (-a13 - a12 * dv_c + sum_u) / dnu
    new_dv = (-a23 - a12 * new_du + sum_v) / dnv
    return new_du, new_dv
