"""The row-sharded relaxation kernel's schedule (csrc/sharded.cu), emulated in
numpy, against the plain versions the CPU runs: ``relax_sharded``
(parallel/halo.py) and the unsharded ``relax`` (solver/level.py).

The emulation follows the kernel: each shard keeps its buffer of planes
over its padded rows, NaN in every row the kernel has not yet written (the
copy-in fills the owned rows of uv, fxyz, J and T = uv); every k outers, with
more than one shard, a push copies each shard's edge owned rows into its
neighbours' halo rows (at outer 0 also those of uv, fxyz and J); each outer
runs the prologue tiles over the whole padded buffer (``prologue_emulated``:
a 64 x 8 tile stages T over the tile plus a 2-pixel ring at buffer
coordinates, phi over the tile plus a 1-pixel ring, the hoists of the tile
from it; a fresh NaN hoist buffer each outer) and then ceil(inner / 5) passes
of k-sweep regions over the buffer (``ksweep_emulated`` of
tests/test_torch_ksweep.py, 64 x 32 regions; each pass writes a fresh NaN
buffer). The buffer is the "image" of both bodies: its edges are mirror
edges, and the free-boundary weights take global rows. Its owned rows must
be bitwise those of ``relax_sharded`` and ``relax``.

The same prologue emulation at the level kernel's 32 x 8 tile, and at the
sharded kernel's 64 x 8, on whole levels and on blocks of rows of a taller
level, is bitwise ``outer_prologue_plain``; it asserts that every T entry
phi reads was staged. A last test reads the tile constants from the kernel
sources.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from test_torch_ksweep import ksweep_emulated

from tpuflow_torch.config import DataConstancy, FlowConfig
from tpuflow_torch.ops import level as L
from tpuflow_torch.ops.cuda_lib import CSRC, STREAMLESS_SIGNATURES
from tpuflow_torch.parallel import make_mesh, relax_sharded, row_split
from tpuflow_torch.parallel.halo import MIN_SHARD_ROWS, halo_applicable, halo_rows
from tpuflow_torch.parallel.halo_kernel import (
    SHARDED_PROLOGUE_TW, grid_syncs, relax_sharded_kernel, row_barriers,
)
from tpuflow_torch.solver.level import LevelScalars, relax

torch.set_num_threads(2)

F = np.float32
E_S2 = F(0.001) * F(0.001)
E_D2 = F(0.001) * F(0.001)
OUTER = 3   # with k = 2: pushes before outers 0 and 2


def refl(i, n):
    return np.where(i < 0, -i, np.where(i >= n, 2 * n - i - 2, i))


def recip_twice_sqrt(a):
    """1 / (2 sqrt(a)) by torch's elementwise functions, as the plain version
    takes it: torch's CPU sqrt is not correctly rounded on every float (with
    AVX-512 it gives 0.36753300 for the square root of 0.13508052, where
    numpy gives 0.36753303), while on the card sqrtf and torch.sqrt both
    are."""
    return torch.reciprocal(2.0 * torch.sqrt(torch.from_numpy(np.ascontiguousarray(a)))).numpy()


def phi_np(tu_xp, tu_xm, tu_yp, tu_ym, tv_xp, tv_xm, tv_yp, tv_ym, sc):
    """tf_body::phi_of in numpy float32."""
    dux = (tu_xp - tu_xm) / sc.div2hx
    duy = (tu_yp - tu_ym) / sc.div2hy
    dvx = (tv_xp - tv_xm) / sc.div2hx
    dvy = (tv_yp - tv_ym) / sc.div2hy
    return recip_twice_sqrt(dux * dux + duy * duy + dvx * dvx + dvy * dvy + E_S2)


def hoists_np(phi, tu_c, tv_c, p, x, w, gy, gh, sc, tensor):
    """tf_body::hoists_px in numpy float32: phi = (c, xp, xm, yp, ym); p the
    planes u, v, fx, fy, ft (, J x5) at the tile's pixels; x and gy the
    tile's columns and global rows."""
    phi_c, phi_xp, phi_xm, phi_yp, phi_ym = phi
    zero, half = F(0.0), F(0.5)
    xp_w = np.where(x < w - 1, sc.alpha_hx2, zero)[None, :]
    xm_w = np.where(x > 0, sc.alpha_hx2, zero)[None, :]
    yp_w = np.where(gy < gh - 1, sc.alpha_hy2, zero)[:, None]
    ym_w = np.where(gy > 0, sc.alpha_hy2, zero)[:, None]
    pw_xp = (phi_xp + phi_c) * half * xp_w
    pw_xm = (phi_xm + phi_c) * half * xm_w
    pw_yp = (phi_yp + phi_c) * half * yp_w
    pw_ym = (phi_ym + phi_c) * half * ym_w
    sum_h = pw_xp + pw_xm + pw_yp + pw_ym
    u, v, fx, fy, ft = p[:5]
    du, dv = tu_c - u, tv_c - v
    sq = ((fx * fx * du + fx * fy * dv + fx * ft) * du
          + (fx * fy * du + fy * fy * dv + fy * ft) * dv
          + (fx * ft * du + fy * ft * dv + ft * ft))
    ksi = recip_twice_sqrt(np.maximum(sq, zero) + E_D2)
    J11, J22, J12, J13, J23 = p[5:10] if tensor else (fx * fx, fy * fy, fx * fy, fx * ft,
                                                     fy * ft)
    return np.stack([pw_xp, pw_xm, pw_yp, pw_ym, ksi * J12, ksi * J13, ksi * J23,
                     ksi * J11 + sum_h, ksi * J22 + sum_h])


def prologue_emulated(T, uv, fxyz, J, sc, tw, gy0=0, gh=None):
    """tf_body::prologue_tile over every tw x 8 tile of a block of h rows
    (its buffer coordinates), whose first row is global row gy0 of a level
    of gh rows. Returns the 9 hoists, NaN wherever no tile wrote."""
    _, h, w = T.shape
    gh = h if gh is None else gh
    th = L.PROLOGUE_TH
    planes = np.concatenate([uv, fxyz] + ([] if J is None else [J]))
    hoist = np.full((9, h, w), np.nan, np.float32)
    rr, cc = np.meshgrid(np.arange(th + 4), np.arange(tw + 4), indexing="ij")
    pr, pc = np.meshgrid(np.arange(th + 2), np.arange(tw + 2), indexing="ij")
    for (_, (y0, y1, x0, x1)) in L.prologue_tiles(h, w, tw):
        gy, gx = y0 - 2 + rr, x0 - 2 + cc
        inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
        ts = np.full((2, th + 4, tw + 4), np.nan, np.float32)
        ts[:, inside] = T[:, gy[inside], gx[inside]]
        qy, qx = y0 - 1 + pr, x0 - 1 + pc
        used = (qy <= h) & (qx <= w)
        py, px = refl(qy, h), refl(qx, w)
        cy, cx = py - y0 + 2, px - x0 + 2
        xp, xm = refl(px + 1, w) - x0 + 2, refl(px - 1, w) - x0 + 2
        yp, ym = refl(py + 1, h) - y0 + 2, refl(py - 1, h) - y0 + 2
        for r_, c_ in ((cy, xp), (cy, xm), (yp, cx), (ym, cx)):
            assert ((r_[used] >= 0) & (r_[used] < th + 4)).all()
            assert ((c_[used] >= 0) & (c_[used] < tw + 4)).all()
            assert inside[r_[used], c_[used]].all(), "phi reads an unstaged T entry"
        idx = [(np.clip(r_, 0, th + 3), np.clip(c_, 0, tw + 3))
               for r_, c_ in ((cy, xp), (cy, xm), (yp, cx), (ym, cx))]
        with np.errstate(invalid="ignore"):
            phi = phi_np(*(ts[0][i] for i in idx), *(ts[1][i] for i in idx), sc)
        phi[~used] = np.nan
        ty, tx = y1 - y0, x1 - x0
        cross = (phi[1:ty + 1, 1:tx + 1], phi[1:ty + 1, 2:tx + 2], phi[1:ty + 1, 0:tx],
                 phi[2:ty + 2, 1:tx + 1], phi[0:ty, 1:tx + 1])
        hoist[:, y0:y1, x0:x1] = hoists_np(
            cross, ts[0][2:ty + 2, 2:tx + 2], ts[1][2:ty + 2, 2:tx + 2],
            planes[:, y0:y1, x0:x1], np.arange(x0, x1), w, gy0 + np.arange(y0, y1), gh, sc,
            J is not None)
    return hoist


def sharded_emulated(fxyz, uv, sc, cfg, n_y, k, J=None):
    """csrc/sharded.cu's relax_sharded_kernel<TENSOR>, phase by phase, every
    shard's buffer in numpy. Returns the owned rows of T, and the grid syncs
    the schedule made."""
    _, h, w = uv.shape
    halo = halo_rows(cfg, k)
    shards = row_split(h, n_y, halo)
    names = ["uv", "fxyz"] + ([] if J is None else ["J"])
    src = {"uv": uv, "fxyz": fxyz, "J": J}
    bufs = []
    for sh in shards:
        own = np.s_[:, sh.top:sh.top + sh.rows]
        b = {n: np.full((src[n].shape[0], sh.padded, w), np.nan, np.float32) for n in names}
        for n in names:
            b[n][own] = src[n][:, sh.row0:sh.row0 + sh.rows]
        b["T"] = b["uv"].copy()
        bufs.append(b)

    def push(name):
        for s in range(n_y - 1):
            a, b = shards[s], shards[s + 1]
            end = a.top + a.rows
            bufs[s + 1][name][:, :halo] = bufs[s][name][:, end - halo:end]
            bufs[s][name][:, end:] = bufs[s + 1][name][:, b.top:b.top + halo]

    syncs = 0
    inner = cfg.inner_iterations_count
    for i in range(cfg.outer_iterations_count):
        syncs += 1
        if n_y > 1 and i % k == 0:
            for name in (names if i == 0 else []) + ["T"]:
                push(name)
            syncs += 1
        for b, sh in zip(bufs, shards):
            assert np.isfinite(b["T"]).all()
            b["hoist"] = prologue_emulated(b["T"], b["uv"], b["fxyz"], b.get("J"), sc,
                                           SHARDED_PROLOGUE_TW, sh.first, h)
            assert np.isfinite(b["hoist"]).all()
        syncs += 1
        for done in range(0, inner, L.KMAX):
            syncs += done > 0
            for b in bufs:
                b["T"] = ksweep_emulated(b["T"], b["uv"], b["hoist"], min(L.KMAX, inner - done),
                                         L.KSWEEP_RW, L.KSWEEP_RH)
    syncs += 1
    out = np.concatenate([b["T"][:, sh.top:sh.top + sh.rows] for b, sh in zip(bufs, shards)],
                         axis=1)
    return out, syncs


def level_inputs(h, w, seed):
    """Seeded uv, grey derivatives of seeded frames, and a gradient tensor."""
    rng = np.random.default_rng(seed)
    f0 = torch.from_numpy((rng.random((h, w)) * 255.0).astype(np.float32))
    f1 = torch.from_numpy((rng.random((h, w)) * 255.0).astype(np.float32))
    uv = (rng.standard_normal((2, h, w)) * 2.0).astype(np.float32)
    sc = LevelScalars.make(w, h, 1.3, 1.2, 35.0)
    fxyz = L.level_derivs(f0, f1, sc.div4hx, sc.div4hy)
    J = L.level_tensor(f0, f1, fxyz, sc, False)
    return uv, fxyz.numpy(), J.numpy(), sc


def check_sharded(h, w, n_y, k, inner, constancy, seed=0):
    cfg = FlowConfig(outer_iterations_count=OUTER, inner_iterations_count=inner,
                     data_constancy=DataConstancy(constancy))
    assert halo_applicable(h, n_y, cfg, k)
    uv, fxyz, J, sc = level_inputs(h, w, seed)
    J = None if constancy == "grey" else J
    got, syncs = sharded_emulated(fxyz, uv, sc, cfg, n_y, k, J)
    assert np.isfinite(got).all()
    Jt = None if J is None else torch.from_numpy(J)
    args = (torch.from_numpy(fxyz), torch.from_numpy(uv), sc, cfg)
    plain = relax_sharded(*args, make_mesh(n_y, device="cpu"), k, J=Jt).numpy()
    assert got.tobytes() == plain.tobytes()
    assert got.tobytes() == relax(*args, J=Jt).numpy().tobytes()
    assert syncs == grid_syncs(cfg, n_y, k)


def min_rows(n_y, k, inner):
    """The fewest rows the gate admits: every shard owns max(halo, 16)."""
    return n_y * max(k * (inner + 1), MIN_SHARD_ROWS)


WIDTHS = {1: 53, 2: 64, 3: 65, 4: 59, 8: 2}


@pytest.mark.parametrize("constancy", ["grey", "gradient"])
@pytest.mark.parametrize("inner", [1, 5, 7])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n_y", [1, 2, 3, 4, 8])
def test_emulated_kernel_is_plain_and_relax_bitwise(n_y, k, inner, constancy):
    """At the gate's minimum rows (every edge shard's padded rows fewer than
    a 32-row region), widths 2 to 65."""
    check_sharded(min_rows(n_y, k, inner), WIDTHS[n_y], n_y, k, inner, constancy,
                  seed=n_y * 10 + k + inner)


@pytest.mark.parametrize("w", [2, 53, 54, 55, 63, 64, 65, 300])
def test_emulated_kernel_at_level_widths(w):
    """Widths about a 64-pixel tile and a 54-pixel region, and 300; 3 uneven
    shards (23, 22, 22 rows)."""
    check_sharded(min_rows(3, 1, 5) + 19, w, 3, 1, 5, "gradient" if w % 2 else "grey", seed=w)


@pytest.mark.parametrize("tensor", [False, True])
@pytest.mark.parametrize("tw", [L.PROLOGUE_TW, SHARDED_PROLOGUE_TW])
@pytest.mark.parametrize("h,w", [(2, 2), (3, 5), (13, 22), (9, 33), (17, 65), (31, 97), (8, 64),
                                 (9, 129)])
def test_prologue_tile_emulation_is_the_plain_prologue_bitwise(h, w, tw, tensor):
    rng = np.random.default_rng(h * w)
    uv, fxyz, J, sc = level_inputs(h, w, h + w)
    T = (uv + rng.standard_normal((2, h, w)) * 0.1).astype(np.float32)
    J = J if tensor else None
    got = prologue_emulated(T, uv, fxyz, J, sc, tw)
    assert np.isfinite(got).all()
    t = torch.from_numpy
    want = L.outer_prologue_plain(t(T), t(uv), t(fxyz), sc.div2hx, sc.div2hy, sc.alpha_hx2,
                                  sc.alpha_hy2, E_S2, E_D2, J=None if J is None else t(J))
    assert got.tobytes() == want.numpy().tobytes()
    # a block of the rows [3, h) of a level 5 rows taller, as a shard's padded rows
    if h > 4:
        blk = np.s_[:, 3:]
        got = prologue_emulated(T[blk].copy(), uv[blk].copy(), fxyz[blk].copy(),
                                None if J is None else J[blk].copy(), sc, tw, 3, h + 5)
        want = L.outer_prologue_plain(
            t(T[blk].copy()), t(uv[blk].copy()), t(fxyz[blk].copy()), sc.div2hx, sc.div2hy,
            sc.alpha_hx2, sc.alpha_hy2, E_S2, E_D2,
            J=None if J is None else t(J[blk].copy()), row0=3, height=h + 5)
        assert got.tobytes() == want.numpy().tobytes()


def test_tile_constants_match_the_kernel_sources():
    def consts(name):
        src = (CSRC / name).read_text()
        pattern = r"constexpr int (\w+) = ([\w:]+);"
        return {m.group(1): m.group(2) for m in re.finditer(pattern, src)}

    body, level, sharded = consts("level_body.cuh"), consts("level.cu"), consts("sharded.cu")
    assert int(body["PRO_TH"]) == L.PROLOGUE_TH
    assert int(level["PRO_TW"]) == L.PROLOGUE_TW
    assert int(body["KS_RW"]) == L.KSWEEP_RW and int(body["KS_RH"]) == L.KSWEEP_RH
    assert int(body["KS_KMAX"]) == L.KMAX
    # the sharded kernel's prologue tile is a region's width, its block a region's
    assert sharded["SH_PRO_TW"] == "KS_RW" and SHARDED_PROLOGUE_TW == L.KSWEEP_RW
    assert "tf_body::KS_THREADS" in sharded["THREADS"]
    # one block an SM, so that the k-sweep's constants have their registers
    assert "__launch_bounds__(THREADS, 1)" in (CSRC / "sharded.cu").read_text()


def test_grid_syncs_per_level():
    """2 syncs an outer at inner <= 5 and one shard, 3 with a push."""
    cfg = FlowConfig()
    assert grid_syncs(cfg, 1) == 40 * 2 + 1
    assert grid_syncs(cfg, 4) == 40 * 3 + 1
    assert grid_syncs(cfg, 4, 2) == 40 * 2 + 20 + 1
    assert grid_syncs(FlowConfig(inner_iterations_count=7), 4) == 40 * 4 + 1


def test_sync_counter_is_the_kernels_alone():
    """Every grid sync of the kernel goes through the one helper that counts
    it; the plain version, which makes none, refuses a counter."""
    src = (CSRC / "sharded.cu").read_text()
    assert src.count("grid.sync()") == 1 and "grid.sync();\n  if (syncs != nullptr" in src
    cfg = FlowConfig(outer_iterations_count=OUTER)
    uv, fxyz, _, sc = level_inputs(40, 9, seed=1)
    args = (torch.from_numpy(fxyz), torch.from_numpy(uv), sc, cfg, make_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="syncs"):
        relax_sharded_kernel(*args, syncs=torch.zeros(1, dtype=torch.int32))
    assert relax_sharded_kernel(*args).numpy().tobytes() == relax_sharded(*args).numpy().tobytes()


def test_relax_levels_needs_cuda(monkeypatch):
    from tpuflow_torch.profile_pair import main, relax_by_level

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        relax_by_level(64, 48)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--size", "64x48", "--relax-levels"])


@pytest.mark.parametrize("processes", [False, True])
def test_grid_syncs_per_level_in_both_modes(processes):
    """Across cards each row barrier is one sync more than the sync it
    replaces; over processes the launch ends with one more row barrier (two
    syncs). On one card, or with one shard, the modes do not differ."""
    cfg = FlowConfig()
    last = 2 if processes else 0
    assert grid_syncs(cfg, 4, 1, 4, processes) == 40 * 3 + 1 + 80 + last
    assert grid_syncs(cfg, 2, 2, 2, processes) == 40 * 2 + 20 + 1 + 40 + last
    assert grid_syncs(cfg, 4, 1, 1, processes) == 40 * 3 + 1
    assert grid_syncs(cfg, 1, 1, 2, processes) == 40 * 2 + 1
    assert row_barriers(cfg, 4, 4, 1, processes) == 80 + last // 2


C_TYPES = {"int": ctypes.c_int, "unsigned int": ctypes.c_uint, "float": ctypes.c_float,
           "size_t": ctypes.c_size_t, "unsigned long long": ctypes.c_uint64}


def c_entries(src):
    """{name: [ctypes type of each argument]} of the extern "C" entry points
    of a source (pointers as c_void_p)."""
    out = {}
    for m in re.finditer(r"^int (tf_\w+)\(([^)]*)\) \{", src, re.M):
        types = []
        for arg in " ".join(m.group(2).split()).split(","):
            decl = arg.strip().rsplit(" ", 1)[0].replace("const ", "").strip()
            if "*" in arg:
                types.append(ctypes.c_void_p)
            else:
                types.append(C_TYPES[decl])
        out[m.group(1)] = types
    return out


def test_streamless_signatures_match_the_sources():
    """cuda_lib's argtypes of the sharded kernel's and the IPC arena's entry
    points are the C declarations', argument for argument."""
    entries = c_entries((CSRC / "sharded.cu").read_text())
    assert set(entries) == set(STREAMLESS_SIGNATURES)
    for name, types in entries.items():
        assert list(STREAMLESS_SIGNATURES[name]) == types, name
    assert len(entries["tf_relax_sharded"]) == 29
