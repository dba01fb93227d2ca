"""The outer prologue of tpuflow_torch (``ops/level.outer_prologue``, whose
plain version the CPU runs) against the JAX package's XLA computation of the
same quantities, on seeded numpy inputs:

  * phi of the iterate T from ``tpuflow.ops.solver_ops.compute_phi_ksi``
    with u = T and du = dv = 0, ksi from the same function with u = uv and
    du = T - uv (the port's du, rounded as the port rounds it), the
    free-boundary weights from ``_edge_weights``, the grey derivatives from
    ``_grey_derivatives``; the 9 hoists composed from them as
    ``level_fused.py:354-393`` writes them;
  * grey (J from fx, fy, ft) and with a gradient/log tensor J;
  * the whole level, and a block of rows of a taller level (``row0`` and
    ``height``, a shard's padded rows): phi reflects at the block's own
    edges, the weights are the global rows' (``_edge_weights`` of the whole
    level, sliced);
  * at the edge shapes of the CUDA kernel's 32 x 8 tiles, w = 2 and h = 2
    among them (the default schedule's coarsest level is 22 x 13).

Bound: both sides round every operation as IEEE float32 in the same
association, but XLA on the CPU evaluates some of them its own way: 99% of
the values agree bitwise, the rest within 1.9e-7 relative (2 ulp). rtol
1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpuflow.ops.solver_ops import _edge_weights, _grey_derivatives, _shifts, compute_phi_ksi

from tpuflow_torch.ops.level import level_derivs, outer_prologue, outer_prologue_plain
from tpuflow_torch.solver.level import LevelScalars

torch.set_num_threads(2)

# (h, w): tile edges of the kernel (partial tiles, one-column and one-row
# remainders, the smallest level the plain version takes)
SHAPES = [(2, 2), (3, 5), (13, 22), (9, 33), (17, 65), (31, 97)]
HX, HY, ALPHA, E_S, E_D = 1.3, 1.2, 35.0, 0.001, 0.001
F = np.float32


def inputs(h: int, w: int, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f0, f1 = (rng.random((2, h, w), np.float32) * 255.0)
    uv = (rng.standard_normal((2, h, w)) * 2.0).astype(np.float32)
    T = uv + (rng.standard_normal((2, h, w)) * 0.1).astype(np.float32)
    J = rng.standard_normal((5, h, w)).astype(np.float32)
    return dict(f0=f0, f1=f1, uv=uv, T=T, J=J)


def jax_hoists(x: dict, tensor: bool, row0: int = 0, height: int | None = None) -> np.ndarray:
    """(9, h, w) hoists from the JAX package's phi, ksi, weights and
    derivatives, in level_fused.py's expressions."""
    f0, f1, uv, T = (jnp.asarray(x[k]) for k in ("f0", "f1", "uv", "T"))
    h, w = x["f0"].shape
    zero = jnp.zeros((h, w), jnp.float32)
    phi, _ = compute_phi_ksi(f0, f1, T[0], T[1], zero, zero, HX, HY, E_S, E_D)
    du, dv = (jnp.asarray(x["T"][i] - x["uv"][i]) for i in (0, 1))
    _, ksi = compute_phi_ksi(f0, f1, uv[0], uv[1], du, dv, HX, HY, E_S, E_D)
    xp_w, xm_w, yp_w, ym_w = (a[row0:row0 + h] for a in _edge_weights(
        h if height is None else height, w, HX, HY, ALPHA))
    phi_c, phi_xp, phi_xm, phi_yp, phi_ym = _shifts(phi)
    pw = [(p + phi_c) * 0.5 * wt for p, wt in
          ((phi_xp, xp_w), (phi_xm, xm_w), (phi_yp, yp_w), (phi_ym, ym_w))]
    sum_h = pw[0] + pw[1] + pw[2] + pw[3]
    if tensor:
        J11, J22, J12, J13, J23 = (jnp.asarray(a) for a in x["J"])
    else:
        fx, fy, ft = _grey_derivatives(f0, f1, HX, HY)
        J11, J22, J12, J13, J23 = fx * fx, fy * fy, fx * fy, fx * ft, fy * ft
    out = pw + [ksi * J12, ksi * J13, ksi * J23, ksi * J11 + sum_h, ksi * J22 + sum_h]
    return np.stack([np.asarray(a) for a in out])


def port_hoists(x: dict, tensor: bool, row0: int = 0, height: int | None = None,
                plain=outer_prologue_plain) -> np.ndarray:
    h, w = x["f0"].shape
    sc = LevelScalars.make(w, h, HX, HY, ALPHA)
    T, uv = torch.from_numpy(x["T"]), torch.from_numpy(x["uv"])
    fxyz = level_derivs(torch.from_numpy(x["f0"]), torch.from_numpy(x["f1"]),
                        sc.div4hx, sc.div4hy)
    J = torch.from_numpy(x["J"]) if tensor else None
    args = (sc.div2hx, sc.div2hy, sc.alpha_hx2, sc.alpha_hy2, F(E_S) * F(E_S), F(E_D) * F(E_D))
    kw = {} if plain is outer_prologue else dict(row0=row0, height=height)
    return plain(T, uv, fxyz, *args, J=J, **kw).numpy()


@pytest.mark.parametrize("tensor", [False, True], ids=["grey", "tensor"])
@pytest.mark.parametrize("h,w", SHAPES)
def test_prologue_matches_jax_whole_level(h, w, tensor):
    x = inputs(h, w)
    want = jax_hoists(x, tensor)
    got = port_hoists(x, tensor)
    assert got.shape == (9, h, w) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the wrapper on CPU tensors is the plain version
    assert np.array_equal(port_hoists(x, tensor, plain=outer_prologue), got)


@pytest.mark.parametrize("tensor", [False, True], ids=["grey", "tensor"])
@pytest.mark.parametrize("row0", [2, 3], ids=["interior", "bottom"])
@pytest.mark.parametrize("h,w", SHAPES)
def test_prologue_matches_jax_block_of_rows(h, w, row0, tensor):
    # a block of h rows of a level of h + 3: rows 2.. leave a row below it,
    # rows 3.. end at the level's last row
    height = h + 3
    x = inputs(h, w, seed=1)
    want = jax_hoists(x, tensor, row0=row0, height=height)
    got = port_hoists(x, tensor, row0=row0, height=height)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the weights are those of global rows: the block's first row has a
    # neighbour above, and its last row one below only inside the level
    assert (got[3, 0] != 0).all()
    assert (got[2, -1] != 0).all() == (row0 + h < height)
