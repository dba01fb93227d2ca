"""Row sharding of a level's relaxation: the split, the halo exchange, and
``relax_sharded``, the plain version of the sharded kernel (the port of
tpuflow/parallel/halo.py:63-289).

Only the relaxation is sharded; the rest of a level runs on the whole field
(halo.py:28-30). A shard owns contiguous rows, split as ``torch.tensor_split``
splits them (100 rows over 3 shards: 34, 33, 33), and works on a padded
block: its owned rows plus ``halo = k (inner + 1)`` rows of each neighbour
shard, on the sides where it has one. The level's constants (uv, fxyz and J)
exchange their halos once; the iterate T exchanges its halos once every k
outer iterations. In between, each shard runs the prologue and the sweeps on
its whole block, computing the margin redundantly. One outer consumes inner +
1 rows of margin (halo.py:110-114), so after k outers the garbage that the
block's cut edge lets in has just reached the owned rows, and they are
bitwise those of the unsharded ``relax`` for any shard count and k: the same
operations run on the same values (halo.py:121-125).

A block that touches the image edge ends there, so its mirror rule is the
image's; the free-boundary weights take global rows. The port's levels are
exact-size, so the JAX path's ghost-row upkeep and top-row mirror fill have
no counterpart.

``relax_sharded_explicit`` runs the same schedule with each shard's block
on its own mesh position: the prologue and k-sweep kernels on the shard's
device and stream, the halos moved by copies ordered by CUDA events (the
port of the shard_map + ppermute route, halo.py:100-289). Given one field
set a card of a one-process row (the level driver's lanes), each shard
copies its block in from its own card's fields, and each card gets a T of
its own with the rows its later steps read. On a row of
processes each process runs its own shard so, and the halos and T's owned
rows go between the processes as point-to-point messages on the default
group (``group.row_exchange``: NCCL between the cards, gloo on the CPU),
the port of ``ppermute`` across hosts.

On a mesh row whose positions belong to several processes (one position a
process), ``relax_sharded`` holds only this process's shard: it exchanges
halo rows with the neighbour processes by messages over the gloo group
(``group.exchange_with``) at the same points, and gathers T's owned rows
from the row's processes at the end. Every process of the row has the
level's whole fields (each computes them), and gets the whole T.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from tpuflow_torch.config import FlowConfig
from tpuflow_torch.ops.level import (
    N_TENSOR, _check_planes, jacobi_sweeps, jacobi_sweeps_plain, outer_prologue,
    outer_prologue_plain,
)
from tpuflow_torch.parallel.group import (
    exchange_with, process_rank, row_all_gather, row_exchange,
)
from tpuflow_torch.parallel.mesh import Mesh, peer_copy

F = np.float32
MIN_SHARD_ROWS = 16   # below this the JAX pipeline replicates a level (halo.py:66-68)


@dataclasses.dataclass(frozen=True)
class ShardRows:
    """One shard's rows: ``rows`` owned from global row ``row0``, with ``top``
    halo rows above and ``bot`` below (0 at the image edge)."""

    row0: int
    rows: int
    top: int
    bot: int

    @property
    def padded(self) -> int:
        return self.top + self.rows + self.bot

    @property
    def first(self) -> int:
        """Global row of the padded block's first row."""
        return self.row0 - self.top


def halo_rows(cfg: FlowConfig, k_outer: int = 1) -> int:
    """Rows of true dependence one exchange must carry for k outer
    iterations (halo.py:135)."""
    return k_outer * (cfg.inner_iterations_count + 1)


def row_split(h: int, n_y: int, halo: int) -> List[ShardRows]:
    """The shards of h rows: contiguous, the first ``h % n_y`` one row
    longer (``torch.tensor_split``), padded by ``halo`` toward neighbours."""
    q, r = divmod(h, n_y)
    shards, row0 = [], 0
    for s in range(n_y):
        rows = q + (1 if s < r else 0)
        shards.append(ShardRows(row0, rows, halo if s > 0 else 0, halo if s < n_y - 1 else 0))
        row0 += rows
    return shards


def halo_applicable(h: int, n_y: int, cfg: FlowConfig, k_outer: int = 1) -> bool:
    """Every shard owns at least max(halo, 16) rows (halo.py:63-79): the
    exchange sends a shard's outermost ``halo`` rows, and below 16 rows a
    shard is not worth its margin. Uneven splits are allowed."""
    if n_y < 1 or k_outer < 1:
        return False
    return h // n_y >= max(halo_rows(cfg, k_outer), MIN_SHARD_ROWS)


def _exchange(blocks: List[torch.Tensor], shards: List[ShardRows], halo: int) -> None:
    """Fill each shard's halo rows, in place, with its neighbours' edge owned
    rows: a shard's bottom rows go to the next shard's top halo, its top rows
    to the previous shard's bottom halo (halo.py:82-97, with tensor copies
    for ``ppermute``). ``blocks`` are (planes, padded rows, w)."""
    for s in range(len(shards) - 1):
        a, b = shards[s], shards[s + 1]
        end = a.top + a.rows
        blocks[s + 1][:, :halo] = blocks[s][:, end - halo:end]
        blocks[s][:, end:] = blocks[s + 1][:, b.top:b.top + halo]


def _pad(x: torch.Tensor, shards: List[ShardRows], halo: int) -> List[torch.Tensor]:
    """(planes, h, w) -> one zero-padded block per shard, owned rows copied
    in and halos exchanged."""
    blocks = []
    for sh in shards:
        block = x.new_zeros((x.shape[0], sh.padded, x.shape[2]))
        block[:, sh.top:sh.top + sh.rows] = x[:, sh.row0:sh.row0 + sh.rows]
        blocks.append(block)
    _exchange(blocks, shards, halo)
    return blocks


def check_sharded_args(fxyz, uv, cfg: FlowConfig, mesh: Mesh, k_outer: int, J) -> int:
    """Check the arguments of the sharded relaxation; returns the halo rows."""
    _, h, w = uv.shape
    _check_planes(h, w, uv=(uv, 2), fxyz=(fxyz, 3))
    if J is not None:
        _check_planes(h, w, J=(J, N_TENSOR))
    if not halo_applicable(h, mesh.n_y, cfg, k_outer):
        raise ValueError(
            f"{h} rows over {mesh.n_y} shards with k_outer={k_outer}: every shard needs at "
            f"least max({halo_rows(cfg, k_outer)}, {MIN_SHARD_ROWS}) rows")
    return halo_rows(cfg, k_outer)


def relax_sharded(fxyz: torch.Tensor, uv: torch.Tensor, sc, cfg: FlowConfig, mesh: Mesh,
                  k_outer: int = 1, J: Optional[torch.Tensor] = None,
                  data: int = 0) -> torch.Tensor:
    """The iterate T (2, h, w) after outer x inner relaxation from T = uv,
    rows sharded over data row ``data`` of ``mesh``, halos exchanged once
    every ``k_outer`` outers: the plain version of ``relax_sharded_kernel``
    and the counterpart of ``relax`` (solver/level.py), bitwise equal to
    it. ``sc`` is the level's ``LevelScalars``; ``J`` the gradient/log
    tensor (None for grey). Runs on the tensors' device; over a row of
    several processes, this process's shard only (module docstring)."""
    halo = check_sharded_args(fxyz, uv, cfg, mesh, k_outer, J)
    shards = row_split(uv.shape[1], mesh.n_y, halo)
    if mesh.row_spans_processes(data):
        return _relax_process_row(fxyz, uv, sc, cfg, mesh.row_ranks(data), shards, halo,
                                  k_outer, J)
    T_b = relax_padded(_pad(fxyz, shards, halo), _pad(uv, shards, halo),
                       None if J is None else _pad(J, shards, halo), sc, cfg, shards, halo,
                       k_outer, uv.shape[1])
    return torch.cat([T[:, sh.top:sh.top + sh.rows] for T, sh in zip(T_b, shards)], dim=1)


def relax_padded(fxyz_b, uv_b, J_b, sc, cfg: FlowConfig, shards: List[ShardRows], halo: int,
                 k_outer: int, h: int, prologue=outer_prologue_plain,
                 sweeps=jacobi_sweeps_plain) -> List[torch.Tensor]:
    """T's padded block of each shard after outer x inner relaxation from T
    = uv, on padded blocks of uv, fxyz and J (None for grey) that hold their
    halos' true rows, so the exchange before the first outer moves nothing
    and is left out; T's halos are exchanged once every ``k_outer`` outers
    after it. ``prologue`` and ``sweeps`` run each outer on a block (by
    default the plain versions; the emulated lanes give the steps they
    run)."""
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)
    J_b = [None] * len(shards) if J_b is None else J_b
    T_b = [b.clone() for b in uv_b]
    for i in range(cfg.outer_iterations_count):
        if i and i % k_outer == 0:
            _exchange(T_b, shards, halo)
        for s, sh in enumerate(shards):
            T_b[s] = _outer(T_b[s], uv_b[s], fxyz_b[s], J_b[s], sc, cfg, e_s2, e_d2, sh, h,
                            prologue, sweeps)
    return T_b


def _outer(T, uv, fxyz, J, sc, cfg: FlowConfig, e_s2, e_d2, sh: ShardRows, h: int,
           prologue=outer_prologue_plain, sweeps=jacobi_sweeps_plain):
    """One outer iteration on a shard's padded block (the plain version by
    default)."""
    hoist = prologue(T, uv, fxyz, sc.div2hx, sc.div2hy, sc.alpha_hx2, sc.alpha_hy2,
                     e_s2, e_d2, J=J, row0=sh.first, height=h)
    return sweeps(T, uv, hoist, cfg.inner_iterations_count)


def owned_rows(fields, groups, shards: List[ShardRows]) -> torch.Tensor:
    """One whole field from each card's copy of it (``fields``, one a card
    of ``groups``: (device, shard indices) a card): every shard's owned
    rows from its card's copy."""
    whole = torch.empty_like(fields[0])
    for field, (_, ys) in zip(fields, groups):
        for y in ys:
            rows = slice(shards[y].row0, shards[y].row0 + shards[y].rows)
            whole[:, rows] = field[:, rows].to(whole.device)
    return whole


def padded_rows(fields, groups, shards: List[ShardRows]) -> List[torch.Tensor]:
    """Each shard's padded block from its own card's copy of a field
    (``fields``, one a card of ``groups``), as the explicit route copies
    it in: a copy of those rows, on its card."""
    card = {y: c for c, (_, ys) in enumerate(groups) for y in ys}
    return [fields[card[s]][:, sh.first:sh.first + sh.padded].contiguous()
            for s, sh in enumerate(shards)]


def card_rows(shards: List[ShardRows], ys, need=None) -> List[Tuple[int, int, int]]:
    """The rows of T that the card holding shards ``ys`` gets from each
    shard on the explicit route, (shard, lo, hi): its own shards' owned
    rows, and every other shard's owned rows inside ``need`` (the rows of
    T that the card's later steps read; every row where None)."""
    out = []
    for s, sh in enumerate(shards):
        lo, hi = sh.row0, sh.row0 + sh.rows
        if s not in ys and need is not None:
            lo, hi = max(lo, need[0]), min(hi, need[1])
        if lo < hi:
            out.append((s, lo, hi))
    return out


def card_copies(shards: List[ShardRows], groups, needs, w: int) -> dict:
    """The peer copies (``mesh.peer_copy``, a plane a copy) of one explicit
    level's T in the form with one field set a card: the other shards'
    owned rows that each card of ``groups`` (its shard indices) reads
    (``needs``, one (lo, hi) a card), a w-wide level."""
    messages = nbytes = 0
    for ys, need in zip(groups, needs):
        for s, lo, hi in card_rows(shards, ys, need):
            if s not in ys:
                messages, nbytes = messages + 2, nbytes + 2 * (hi - lo) * w * 4
    return {"messages": messages, "bytes": nbytes}


def _exchange_processes(block: torch.Tensor, s: int, shards: List[ShardRows], halo: int,
                        ranks) -> None:
    """``_exchange`` for shard s of a row of processes, in place: its edge
    owned rows go to the neighbour processes, their edge rows come into its
    halo rows, as messages over the gloo group (through host memory)."""
    sh, n = shards[s], len(shards)
    end = sh.top + sh.rows
    host = block.detach().cpu()
    sends, recvs = [], []
    if s > 0:
        sends.append((ranks[s - 1], host[:, sh.top:sh.top + halo]))
        recvs.append((ranks[s - 1], torch.empty_like(host[:, :halo])))
    if s < n - 1:
        sends.append((ranks[s + 1], host[:, end - halo:end]))
        recvs.append((ranks[s + 1], torch.empty_like(host[:, end:])))
    exchange_with(sends, recvs)
    for (r, got) in recvs:
        rows = slice(0, halo) if s > 0 and r == ranks[s - 1] else slice(end, sh.padded)
        block[:, rows] = got.to(block.device)


def _relax_process_row(fxyz, uv, sc, cfg: FlowConfig, ranks, shards: List[ShardRows],
                       halo: int, k_outer: int, J) -> torch.Tensor:
    """``relax_sharded`` on a row of processes: this process's shard only,
    its blocks' halos from the neighbour processes, T's owned rows gathered
    from every process of the row."""
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"a row over processes holds one position a process, got ranks {ranks}")
    s = ranks.index(process_rank()[0])
    sh = shards[s]
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)
    fields = [uv, fxyz] + ([] if J is None else [J])
    # the owned rows of every field in one block, the halos from the neighbours
    consts = uv.new_zeros((sum(x.shape[0] for x in fields), sh.padded, uv.shape[2]))
    consts[:, sh.top:sh.top + sh.rows] = torch.cat(fields)[:, sh.row0:sh.row0 + sh.rows]
    _exchange_processes(consts, s, shards, halo, ranks)
    uv_b, fxyz_b = consts[:2], consts[2:5]
    J_b = consts[5:] if J is not None else None
    T = uv_b.clone()
    for i in range(cfg.outer_iterations_count):
        if i % k_outer == 0:
            _exchange_processes(T, s, shards, halo, ranks)
        T = _outer(T, uv_b, fxyz_b, J_b, sc, cfg, e_s2, e_d2, sh, uv.shape[1])
    owned = T[:, sh.top:sh.top + sh.rows].cpu()
    rows = row_all_gather(owned, ranks, [(2, o.rows, uv.shape[2]) for o in shards])
    return torch.cat(rows, dim=1).to(uv.device)


# ---------------------------------------------------------------------------
# The explicit route: one stream a shard, halos by copies between them
# ---------------------------------------------------------------------------


def _event(stream) -> Optional[torch.cuda.Event]:
    """An event recorded on ``stream`` now (None on the CPU)."""
    if stream is None:
        return None
    event = torch.cuda.Event()
    event.record(stream)
    return event


def _copy(dst: torch.Tensor, src: torch.Tensor, dst_stream, src_stream, after) -> None:
    """dst <- src once ``after`` (an event of the stream that wrote src) has
    completed: on dst's stream, or, between two cards, on src's stream
    fenced both ways with dst's, as torch runs such a copy. src is recorded
    to dst's stream, so that its memory is not handed out again before the
    copy has read it."""
    if dst_stream is None:
        dst.copy_(src)
        return
    dst_stream.wait_event(after)
    with torch.cuda.stream(src_stream), torch.cuda.stream(dst_stream):
        dst.copy_(src, non_blocking=True)
    src.record_stream(dst_stream)


def relax_sharded_explicit(fxyz, uv, sc, cfg: FlowConfig, mesh: Mesh, k_outer: int = 1,
                           J=None, data: int = 0, rows=None):
    """``relax_sharded`` with shard s on position (``data``, s) of ``mesh``:
    its padded block on that position's device, its prologue (``row0``,
    ``height``: the block's place in the level) and k-sweep kernels on that
    position's stream. The level's fields come from the caller's current
    stream and T goes back to it, on the fields' device.

    Each block is copied in from the level's fields with its halos, which
    are then the true rows, so the exchange before the first outer moves
    nothing and is left out; after it, every ``k_outer`` outers each shard
    records an event after its last sweep, and each halo copy runs on the
    destination's stream after the source's event. The owned rows are
    bitwise those of ``relax_sharded`` and ``relax``. Counts the copies it
    makes between positions and the level's fields in
    ``relax_sharded_explicit.copies``.

    ``fxyz``, ``uv`` and ``J`` as tuples, one entry a card of a one-process
    row (``mesh.row_groups(data)``'s order, each on its card: the level
    driver's lanes, solver/level.py) return one T a card, each on its
    card's current stream (``_explicit_cards``): each shard's block is
    copied in from its own card's fields, and each card's T holds its own
    shards' owned rows and, of the other shards' owned rows, those inside
    its entry of ``rows`` ((lo, hi) a card: the rows of T its add + median
    reads; all of them without ``rows``), which come as peer copies
    (``mesh.peer_copy``). No other row of a card's T is written.

    On a row whose positions belong to several processes (one a process)
    every process of the row calls it at once with the level's fields,
    which each computed itself, and runs only its own shard: its blocks
    copied in from its fields, its exchanges as messages with the
    neighbour processes (``_explicit_process_row``), and every process gets
    the whole T."""
    if isinstance(uv, (tuple, list)):
        return _explicit_cards(tuple(fxyz), tuple(uv), sc, cfg, mesh, k_outer,
                               None if J is None else tuple(J), data, rows)
    halo = check_sharded_args(fxyz, uv, cfg, mesh, k_outer, J)
    _, h, w = uv.shape
    shards = row_split(h, mesh.n_y, halo)
    if mesh.row_spans_processes(data):
        return _explicit_process_row(fxyz, uv, sc, cfg, mesh, shards, halo, k_outer, J, data)
    positions = mesh.row(data)
    if any(mesh.devices[p].type != uv.device.type for p in positions):
        raise ValueError(f"fields on {uv.device} for shards on "
                         f"{[str(mesh.devices[p]) for p in positions]}")
    caller = torch.cuda.current_stream(uv.device) if uv.is_cuda else None
    fields = [uv, fxyz] + ([] if J is None else [J])
    ready = _event(caller)
    T_b, streams, copies = _explicit_shards(lambda s: (fields, caller, ready), sc, cfg, mesh,
                                            shards, halo, k_outer, data, h, w)
    T = torch.empty_like(uv)
    for s, (sh, stream) in enumerate(zip(shards, streams)):
        _copy(T[:, sh.row0:sh.row0 + sh.rows], T_b[s][:, sh.top:sh.top + sh.rows], caller,
              stream, _event(stream))
    relax_sharded_explicit.copies += copies + len(shards)
    return T


def _explicit_shards(source, sc, cfg: FlowConfig, mesh: Mesh, shards: List[ShardRows],
                     halo: int, k_outer: int, data: int, h: int, w: int):
    """The explicit route's shards on their positions: each shard's padded
    blocks copied in from ``source(s)`` (the fields uv, fxyz [, J], the
    stream that wrote them and an event of it), its prologue and k-sweep
    kernels on its position's stream, T's halos copied every ``k_outer``
    outers after the first. Returns (T's padded blocks, the shards'
    streams, the copies made)."""
    positions = mesh.row(data)
    streams = [mesh.stream(p) for p in positions]
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)
    blocks, T_b, copies = [], [], 0
    for s, (sh, p, stream) in enumerate(zip(shards, positions, streams)):
        fields, src_stream, ready = source(s)
        with mesh.on(p):
            mine = [torch.empty((x.shape[0], sh.padded, w), dtype=torch.float32,
                                device=mesh.devices[p]) for x in fields]
            for block, x in zip(mine, fields):
                _copy(block, x[:, sh.first:sh.first + sh.padded], stream, src_stream, ready)
            blocks.append(mine + [None] * (3 - len(mine)))
            T_b.append(mine[0].clone())
        copies += len(fields)
    for i in range(cfg.outer_iterations_count):
        if i and i % k_outer == 0:
            swept = [_event(stream) for stream in streams]
            for s in range(len(shards) - 1):
                a, b = shards[s], shards[s + 1]
                end = a.top + a.rows
                _copy(T_b[s + 1][:, :halo], T_b[s][:, end - halo:end], streams[s + 1],
                      streams[s], swept[s])
                _copy(T_b[s][:, end:], T_b[s + 1][:, b.top:b.top + halo], streams[s],
                      streams[s + 1], swept[s + 1])
            copies += 2 * (len(shards) - 1)
        for s, (sh, p) in enumerate(zip(shards, positions)):
            uv_s, fxyz_s, J_s = blocks[s]
            with mesh.on(p):
                hoist = outer_prologue(T_b[s], uv_s, fxyz_s, sc.div2hx, sc.div2hy, sc.alpha_hx2,
                                       sc.alpha_hy2, e_s2, e_d2, J_s, row0=sh.first, height=h)
                T_b[s] = jacobi_sweeps(T_b[s], uv_s, hoist, cfg.inner_iterations_count)
    return T_b, streams, copies


def check_card_fields(groups, uv, fxyz, J) -> list:
    """Check one field set a card of a one-process row (``groups``,
    ``Mesh.row_groups``'s): each of uv, fxyz and J (None for grey) one
    tensor a card, on that card. Returns the cards."""
    cards = [dev for dev, _ in groups]
    for name, fields in [("uv", uv), ("fxyz", fxyz)] + ([] if J is None else [("J", J)]):
        if len(fields) != len(cards) or any(f.device != dev for f, dev in zip(fields, cards)):
            raise ValueError(f"{name}: one tensor a card of the row, on "
                             f"{[str(d) for d in cards]}, got "
                             f"{[str(f.device) for f in fields]}")
    return cards


def _explicit_cards(fxyz, uv, sc, cfg: FlowConfig, mesh: Mesh, k_outer: int, J, data: int,
                    rows) -> Tuple[torch.Tensor, ...]:
    """``relax_sharded_explicit`` with one field set a card of a one-process
    row (its docstring): each shard's blocks copied in from its own card's
    fields after an event of that card's current stream, one T a card."""
    groups = mesh.row_groups(data)
    cards = check_card_fields(groups, uv, fxyz, J)
    n = len(cards)
    if rows is not None and len(rows) != n:
        raise ValueError(f"rows: one (lo, hi) a card of the row, got {len(rows)} for {n}")
    if mesh.row_spans_processes(data):
        raise ValueError("a row over processes gives each process its own fields alone")
    halo = check_sharded_args(fxyz[0], uv[0], cfg, mesh, k_outer, None if J is None else J[0])
    _, h, w = uv[0].shape
    shards = row_split(h, mesh.n_y, halo)
    card = {y: c for c, (_, ys) in enumerate(groups) for y in ys}
    callers = [torch.cuda.current_stream(dev) if dev.type == "cuda" else None for dev in cards]
    ready = [_event(caller) for caller in callers]   # each card's fields are in

    def source(s):
        c = card[s]
        return [uv[c], fxyz[c]] + ([] if J is None else [J[c]]), callers[c], ready[c]

    T_b, streams, copies = _explicit_shards(source, sc, cfg, mesh, shards, halo, k_outer, data,
                                            h, w)
    Ts = []
    for c, (dev, ys) in enumerate(groups):
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            T = torch.empty_like(uv[c])   # on the card's current stream
        for s, lo, hi in card_rows(shards, ys, None if rows is None else rows[c]):
            a, b = lo - shards[s].first, hi - shards[s].first
            if s in ys:
                _copy(T[:, lo:hi], T_b[s][:, a:b], callers[c], streams[s], _event(streams[s]))
                copies += 1
            else:
                for plane in range(2):
                    peer_copy(T[plane, lo:hi], T_b[s][plane, a:b], callers[c], streams[s])
        Ts.append(T)
    relax_sharded_explicit.copies += copies
    return tuple(Ts)


relax_sharded_explicit.copies = 0


def _halo_messages(T: torch.Tensor, s: int, shards: List[ShardRows], halo: int, ranks):
    """The sends and receives of shard s's exchange of T (2, padded, w), one
    message a plane and side, each a contiguous row range of a plane: its
    top ``halo`` owned rows to s - 1 and its bottom ones to s + 1, their
    edge rows into its halo rows. Both sides list a pair's messages plane
    by plane, so they match in order."""
    sh, n = shards[s], len(shards)
    end = sh.top + sh.rows
    sends, recvs = [], []
    for c in range(T.shape[0]):
        if s > 0:
            sends.append((ranks[s - 1], T[c, sh.top:sh.top + halo]))
            recvs.append((ranks[s - 1], T[c, :sh.top]))
        if s < n - 1:
            sends.append((ranks[s + 1], T[c, end - halo:end]))
            recvs.append((ranks[s + 1], T[c, end:]))
    return sends, recvs


def _explicit_process_row(fxyz, uv, sc, cfg: FlowConfig, mesh: Mesh, shards: List[ShardRows],
                          halo: int, k_outer: int, J, data: int) -> torch.Tensor:
    """``relax_sharded_explicit`` on a row of processes: this process's
    shard s on its position's stream, its padded blocks copied in from the
    level's fields (so the first exchange moves nothing and is left out);
    every ``k_outer`` outers after the first, T's edge owned rows to the
    neighbour processes and theirs into its halo rows, one batch of
    messages on its position's stream; at the end its owned rows into T and
    to every other process of the row, whose owned rows come into T (one
    batch). Counts its copies in and out in ``relax_sharded_explicit.copies``;
    its sends are ``row_exchange``'s to count."""
    ranks = mesh.row_ranks(data)
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"a row over processes holds one position a process, got ranks {ranks}")
    mesh.check_p2p("halo='explicit' over a row of processes")
    me = process_rank()[0]
    s = ranks.index(me)
    p, sh = mesh.row(data)[s], shards[s]
    _, h, w = uv.shape
    e_s2 = F(cfg.equation_smoothness) * F(cfg.equation_smoothness)
    e_d2 = F(cfg.equation_data) * F(cfg.equation_data)
    fields = [uv, fxyz] + ([] if J is None else [J])
    stream = mesh.stream(p)
    caller = torch.cuda.current_stream(uv.device) if uv.is_cuda else None
    ready = _event(caller)
    with mesh.on(p):
        blocks = [torch.empty((x.shape[0], sh.padded, w), dtype=torch.float32, device=uv.device)
                  for x in fields]
        for block, x in zip(blocks, fields):
            _copy(block, x[:, sh.first:sh.first + sh.padded], stream, caller, ready)
        uv_b, fxyz_b = blocks[:2]
        J_b = blocks[2] if J is not None else None
        T_b = uv_b.clone()
        for i in range(cfg.outer_iterations_count):
            if i and i % k_outer == 0:
                row_exchange(*_halo_messages(T_b, s, shards, halo, ranks))
            hoist = outer_prologue(T_b, uv_b, fxyz_b, sc.div2hx, sc.div2hy, sc.alpha_hx2,
                                   sc.alpha_hy2, e_s2, e_d2, J_b, row0=sh.first, height=h)
            T_b = jacobi_sweeps(T_b, uv_b, hoist, cfg.inner_iterations_count)
        T = torch.empty_like(uv)
        T[:, sh.row0:sh.row0 + sh.rows] = T_b[:, sh.top:sh.top + sh.rows]
        sends, recvs = [], []
        for o, r in zip(shards, ranks):
            if r == me:
                continue
            for c in range(2):
                sends.append((r, T[c, sh.row0:sh.row0 + sh.rows]))
                recvs.append((r, T[c, o.row0:o.row0 + o.rows]))
        row_exchange(sends, recvs)
    if caller is not None:
        caller.wait_stream(stream)
        T.record_stream(caller)
    relax_sharded_explicit.copies += len(fields) + 1
    return T


def explicit_exchanges(cfg: FlowConfig, k_outer: int) -> int:
    """The halo exchanges of T in one explicit relaxation: one every
    ``k_outer`` outers after the first."""
    return max(-(-cfg.outer_iterations_count // k_outer) - 1, 0)


def explicit_sends(cfg: FlowConfig, n_y: int, k_outer: int, shard: int) -> int:
    """The messages that the process holding shard ``shard`` of a row of
    ``n_y`` processes sends in one ``relax_sharded_explicit`` call, one a
    plane: two to each neighbour an exchange after the first, two to each
    other process of the row at the end."""
    neighbours = (shard > 0) + (shard < n_y - 1)
    return explicit_exchanges(cfg, k_outer) * 2 * neighbours + 2 * (n_y - 1)


def explicit_copies(h: int, cfg: FlowConfig, n_y: int, k_outer: int = 1,
                    tensor: bool = False, shard: Optional[int] = None) -> int:
    """The copies of one ``relax_sharded_explicit`` call: each shard's
    blocks in (uv, fxyz and J), the halos of every exchange after the first,
    and the owned rows out. The form with one field set a card makes the
    same: each shard's blocks from its own card's fields, and its owned
    rows into its own card's T (the rows of T that cross cards are peer
    copies, ``card_copies``). With ``shard``, the process form: those of
    the process that holds shard ``shard`` of a row over processes, its
    blocks in and its owned rows into T (its messages are
    ``explicit_sends``)."""
    fields = 3 if tensor else 2
    if shard is not None:
        return fields + 1
    return n_y * fields + explicit_exchanges(cfg, k_outer) * 2 * (n_y - 1) + n_y
