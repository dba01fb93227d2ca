"""The row-sharded kernel over several cards (csrc/sharded.cu), emulated in
numpy with each card an actor, against the plain versions the CPU runs:
``relax_sharded`` (parallel/halo.py) and the unsharded ``relax``.

Each card runs its own launch over the shards the row deals it: copy-in,
then per outer the row barrier (or a grid sync) at its top, every k outers
the push of its shards' edge rows into the neighbour shards' halo rows
(another card's buffer where the neighbour lives there) and a row barrier,
the prologue tiles and the k-sweep passes, over each of its shards' padded
rows; then the copy-out. A row barrier stores the card's epoch into its
flag in each neighbour card's memory and waits until each neighbour's flag
in its own memory has reached it. A scheduler advances the cards in any
order the barriers allow (seeded shuffles, and each card first). A grid
sync orders one card's phases only, so in the emulation it is the order of
a card's own steps. NaN marks every halo row no push has filled yet, and
every halo row the last pass before an exchange writes (a neighbour's push
overwrites it). The owned rows are bitwise ``relax_sharded`` and ``relax``;
dropping either row barrier lets a NaN reach an owned row.

The barrier sites and the epoch arithmetic are read from the kernel's
source, and the host's epoch bookkeeping (``RowFlags``) is run over
consecutive launches with different barrier counts.

The process mode (a row whose cards are different processes' launches,
each card its own copy of the level's fields and its own T) is emulated the
same way: each card copies in from its own fields, copies its owned rows
out into every card's T, and meets every card of the row at one more row
barrier; what each card's T holds when its launch ends must be bitwise
``relax_sharded``, and without that barrier some order of the cards ends a
launch with rows of T not yet stored.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

from test_torch_ksweep import ksweep_emulated
from test_torch_sharded_tiles import OUTER, level_inputs, min_rows, prologue_emulated

from tpuflow_torch import models
from tpuflow_torch.config import DataConstancy, FlowConfig
from tpuflow_torch.ops import level as L
from tpuflow_torch.ops.cuda_lib import CSRC
from tpuflow_torch.parallel import make_mesh, relax_sharded, row_split
from tpuflow_torch.parallel.halo import halo_applicable, halo_rows
from tpuflow_torch.parallel.halo_kernel import (
    SHARDED_PROLOGUE_TW, RowFlags, grid_syncs, row_barriers,
)
from tpuflow_torch.solver.level import relax

torch.set_num_threads(2)

KERNEL = (CSRC / "sharded.cu").read_text()
# The kernel's outer loop, in source order: its sync sites and phases.
OUTER_LOOP = ["row_barrier", "grid_sync", "push_halos", "push_halos", "push_halos",
              "row_barrier", "prologue_finish", "grid_sync", "grid_sync"] + ["ksweep_pass<"] * 5
# Which card holds each shard: contiguous blocks, or dealt i % cards.
LAYOUTS = {"2x1": (0, 1), "2x2": (0, 0, 1, 1), "2x2dealt": (0, 1, 0, 1), "4x1": (0, 1, 2, 3),
           "4x2": (0, 0, 1, 1, 2, 2, 3, 3), "4x2dealt": (0, 1, 2, 3, 0, 1, 2, 3)}
# Rows over processes: one shard a process's card.
PROCESS_LAYOUTS = {"2procs": (0, 1), "3procs": (0, 1, 2), "4procs": (0, 1, 2, 3)}
WIDTHS = {2: 64, 3: 53, 4: 59, 8: 2}


class Deadlock(Exception):
    pass


def neighbour_cards(shard_card, c):
    """The cards that hold a shard next to one of card c's (the entry
    point's RowLinks)."""
    n = len(shard_card)
    return sorted({shard_card[t] for s in range(n) if shard_card[s] == c
                   for t in (s - 1, s + 1) if 0 <= t < n and shard_card[t] != c})


def run(actors, policy):
    """Advance generator ``actors`` (card -> generator) until all finish. A
    generator yields None at a step, or a predicate that must hold before
    it may go on (a row barrier's wait); ``policy`` picks the next card
    among those that may."""
    gens, waits = dict(actors), {c: None for c in actors}
    while gens:
        ready = [c for c in gens if waits[c] is None or waits[c]()]
        if not ready:
            raise Deadlock(sorted(gens))
        c = policy(ready)
        try:
            waits[c] = next(gens[c])
        except StopIteration:
            del gens[c]


def seeded(seed):
    rng = np.random.default_rng(seed)
    return lambda ready: ready[int(rng.integers(len(ready)))]


def first(card):
    return lambda ready: card if card in ready else min(ready)


class Row:
    """The flags of a row of cards: flags[c][j] lies in card c's memory and
    is stored by card j; ``origin`` records the launch of each stored value.
    ``faults`` collects every store that lowers a flag and every wait that a
    flag of an earlier launch satisfies."""

    def __init__(self, cards):
        self.flags = [[0] * cards for _ in range(cards)]
        self.origin = [[None] * cards for _ in range(cards)]
        self.faults = []

    def barrier(self, c, nbrs, epoch, launch, counts):
        """csrc/sharded.cu's row_barrier on card c: store the epoch into c's
        flag on every neighbour, then wait for each neighbour's flag."""
        counts["syncs"] += 2
        counts["barriers"] += 1
        for j in nbrs:
            if epoch < self.flags[j][c]:
                self.faults.append(("went back", j, c))
            self.flags[j][c], self.origin[j][c] = epoch, launch
        yield lambda: all(self.flags[c][j] >= epoch for j in nbrs)
        # a neighbour past this barrier may already store for its next launch
        self.faults += [("stale", c, j) for j in nbrs if self.origin[c][j] < launch]


def launch_actor(c, shard_card, cfg, k, row, epoch, launch, counts, work=None, drop=(),
                 processes=False):
    """Card c's launch, step by step; ``work`` (None for the protocol
    alone) holds the shards' buffers and the phases. ``drop`` names row
    barriers the emulation leaves out: "before_push", "after_push", "last"
    (the process mode's). ``processes``: the process mode (each card its
    own fields and T, the copy-out into every card's T, a last row barrier
    over every card)."""
    n_y = len(shard_card)
    nbrs = neighbour_cards(shard_card, c)
    mine = [s for s in range(n_y) if shard_card[s] == c]
    if work:
        work.copy_in(mine)
    yield None
    inner = cfg.inner_iterations_count
    for i in range(cfg.outer_iterations_count):
        push = n_y > 1 and i % k == 0
        epoch += push
        if push and "before_push" not in drop:
            yield from row.barrier(c, nbrs, epoch, launch, counts)
        else:
            counts["syncs"] += 1
        if push:
            if work:
                work.push(mine, i == 0)
            yield None
            epoch += 1
            if "after_push" not in drop:
                yield from row.barrier(c, nbrs, epoch, launch, counts)
            else:
                counts["syncs"] += 1
        if work:
            work.prologue(mine)
        yield None
        counts["syncs"] += 1
        for done in range(0, inner, L.KMAX):
            counts["syncs"] += done > 0
            if work:
                last = done + L.KMAX >= inner
                exchange_next = (n_y > 1 and i + 1 < cfg.outer_iterations_count
                                 and (i + 1) % k == 0)
                work.sweep(mine, min(L.KMAX, inner - done), last and exchange_next)
            yield None
    counts["syncs"] += 1
    if processes:
        if work:
            work.copy_out(mine)
        yield None
        everyone = [j for j in range(max(shard_card) + 1) if j != c]
        if "last" not in drop:
            yield from row.barrier(c, everyone, epoch + 1, launch, counts)
        if work:
            work.ended[c] = work.T_out[c].copy()   # what card c's T holds as its launch ends


class Work:
    """The shards' buffers of one row, NaN in every row not yet written: the
    constants' planes and T twice (ping-pong), each card's ``cur``."""

    def __init__(self, fxyz, uv, J, sc, cfg, shard_card, k, processes=False):
        _, self.h, self.w = uv.shape
        self.sc, self.halo = sc, halo_rows(cfg, k)
        self.shards = row_split(self.h, len(shard_card), self.halo)
        self.names = ["uv", "fxyz"] + ([] if J is None else ["J"])
        self.src = {"uv": uv, "fxyz": fxyz, "J": J}
        cards = max(shard_card) + 1
        self.shard_card = shard_card
        # the process mode: each card its own copy of the fields and its own T
        self.card_src = [{n: None if a is None else a.copy() for n, a in self.src.items()}
                         for _ in range(cards)] if processes else None
        self.T_out = [np.full((2, self.h, self.w), np.nan, np.float32) for _ in range(cards)]
        self.ended = [None] * cards
        self.bufs = [{n: np.full((self.src[n].shape[0], sh.padded, self.w), np.nan, np.float32)
                      for n in self.names} for sh in self.shards]
        for b, sh in zip(self.bufs, self.shards):
            b["T"] = [np.full((2, sh.padded, self.w), np.nan, np.float32) for _ in range(2)]
            b["cur"] = 0

    def copy_in(self, mine):
        for s in mine:
            b, sh = self.bufs[s], self.shards[s]
            src = self.src if self.card_src is None else self.card_src[self.shard_card[s]]
            for n in self.names:
                b[n][:, sh.top:sh.top + sh.rows] = src[n][:, sh.row0:sh.row0 + sh.rows]
            b["T"][0][:, sh.top:sh.top + sh.rows] = src["uv"][:, sh.row0:sh.row0 + sh.rows]

    def copy_out(self, mine):
        """Each of ``mine`` stores its owned rows of T into every card's T."""
        for s in mine:
            b, sh = self.bufs[s], self.shards[s]
            for T in self.T_out:
                T[:, sh.row0:sh.row0 + sh.rows] = b["T"][b["cur"]][:, sh.top:sh.top + sh.rows]

    def push(self, mine, constants):
        """Each of ``mine`` stores its edge owned rows into its neighbours'
        halo rows: the plane of T that is its own current one."""
        for s in mine:
            me, sh = self.bufs[s], self.shards[s]
            for t, rows in ((s - 1, slice(sh.top, sh.top + self.halo)),
                            (s + 1, slice(sh.top + sh.rows - self.halo, sh.top + sh.rows))):
                if not 0 <= t < len(self.shards):
                    continue
                o, osh = self.bufs[t], self.shards[t]
                dst = slice(osh.top + osh.rows, osh.padded) if t < s else slice(0, self.halo)
                for n in self.names if constants else []:
                    o[n][:, dst] = me[n][:, rows]
                o["T"][me["cur"]][:, dst] = me["T"][me["cur"]][:, rows]

    def prologue(self, mine):
        for s in mine:
            b, sh = self.bufs[s], self.shards[s]
            b["hoist"] = prologue_emulated(b["T"][b["cur"]], b["uv"], b["fxyz"], b.get("J"),
                                           self.sc, SHARDED_PROLOGUE_TW, sh.first, self.h)

    def sweep(self, mine, kk, dead_halos):
        for s in mine:
            b, sh = self.bufs[s], self.shards[s]
            nxt = 1 - b["cur"]
            b["T"][nxt][:] = ksweep_emulated(b["T"][b["cur"]], b["uv"], b["hoist"], kk,
                                             L.KSWEEP_RW, L.KSWEEP_RH)
            if dead_halos:   # the next push overwrites them
                b["T"][nxt][:, :sh.top] = np.nan
                b["T"][nxt][:, sh.top + sh.rows:] = np.nan
            b["cur"] = nxt

    def owned(self):
        return np.concatenate([b["T"][b["cur"]][:, sh.top:sh.top + sh.rows]
                               for b, sh in zip(self.bufs, self.shards)], axis=1)


def crosscard_emulated(fxyz, uv, sc, cfg, shard_card, k, J=None, policy=None, drop=()):
    """The kernel's launches on every card of the row, interleaved by
    ``policy``; returns the owned rows of T and each card's counts."""
    cards = max(shard_card) + 1
    work = Work(fxyz, uv, J, sc, cfg, shard_card, k)
    row = Row(cards)
    counts = [{"syncs": 0, "barriers": 0} for _ in range(cards)]
    run({c: launch_actor(c, shard_card, cfg, k, row, 0, 0, counts[c], work, drop)
         for c in range(cards)}, policy or seeded(0))
    assert row.faults == []
    return work.owned(), counts


def case(h, w, n_y, k, inner, constancy, seed):
    cfg = FlowConfig(outer_iterations_count=OUTER, inner_iterations_count=inner,
                     data_constancy=DataConstancy(constancy))
    assert halo_applicable(h, n_y, cfg, k)
    uv, fxyz, J, sc = level_inputs(h, w, seed)
    return cfg, uv, fxyz, (None if constancy == "grey" else J), sc


@pytest.mark.parametrize("constancy", ["grey", "gradient"])
@pytest.mark.parametrize("inner", [1, 5, 7])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cards_as_actors_are_plain_and_relax_bitwise(layout, k, inner, constancy):
    """2 and 4 cards, 1 and 2 shards a card, contiguous and dealt, at the
    gate's minimum rows, in a seeded interleaving of the cards."""
    shard_card = LAYOUTS[layout]
    n_y, cards = len(shard_card), max(shard_card) + 1
    cfg, uv, fxyz, J, sc = case(min_rows(n_y, k, inner), WIDTHS[n_y], n_y, k, inner, constancy,
                                seed=n_y * 10 + k + inner)
    got, counts = crosscard_emulated(fxyz, uv, sc, cfg, shard_card, k, J,
                                     seeded(sorted(LAYOUTS).index(layout) * 100 + k * 10
                                            + inner))
    assert np.isfinite(got).all()
    Jt = None if J is None else torch.from_numpy(J)
    args = (torch.from_numpy(fxyz), torch.from_numpy(uv), sc, cfg)
    plain = relax_sharded(*args, make_mesh(n_y, device="cpu"), k, J=Jt).numpy()
    assert got.tobytes() == plain.tobytes()
    assert got.tobytes() == relax(*args, J=Jt).numpy().tobytes()
    for c in counts:
        assert c == {"syncs": grid_syncs(cfg, n_y, k, cards),
                     "barriers": row_barriers(cfg, n_y, cards, k)}


@pytest.mark.parametrize("layout", ["2x1", "4x2dealt"])
def test_every_card_first_is_bitwise(layout):
    """Each card run as far as the barriers let it before any other."""
    shard_card = LAYOUTS[layout]
    n_y = len(shard_card)
    cfg, uv, fxyz, J, sc = case(min_rows(n_y, 1, 5), 40, n_y, 1, 5, "gradient", seed=7)
    want = relax(torch.from_numpy(fxyz), torch.from_numpy(uv), sc, cfg,
                 J=torch.from_numpy(J)).numpy()
    for c in range(max(shard_card) + 1):
        got, _ = crosscard_emulated(fxyz, uv, sc, cfg, shard_card, 1, J, first(c))
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("drop", ["before_push", "after_push"])
@pytest.mark.parametrize("layout", ["2x1", "4x2dealt"])
def test_each_row_barrier_is_needed(layout, drop):
    """Without the barrier before a push, a card's push can land before its
    neighbour's last pass writes the same halo rows; without the one after,
    a card's prologue can read halo rows its neighbour has not pushed. In
    some order of the cards a NaN then reaches an owned row."""
    shard_card = LAYOUTS[layout]
    n_y = len(shard_card)
    cfg, uv, fxyz, J, sc = case(min_rows(n_y, 1, 5), 40, n_y, 1, 5, "grey", seed=3)
    policies = [first(c) for c in range(max(shard_card) + 1)] + [seeded(s) for s in range(2)]
    reached = [not np.isfinite(crosscard_emulated(fxyz, uv, sc, cfg, shard_card, 1, J, p,
                                                  (drop,))[0]).all() for p in policies]
    assert any(reached)


def test_barrier_sites_and_epochs_are_the_kernels():
    """The emulation's schedule and epoch rule are the kernel's: the sync
    sites of the outer loop in source order, a row barrier at the top of
    an exchange outer in place of the grid sync and one after the push,
    each at the next epoch from the launch's, stored with a system-scope
    release and waited for until each neighbour's flag has reached it."""
    loop = KERNEL[KERNEL.index("for (int i = 0; i < outer; ++i) {"):
                  KERNEL.index("  grid_sync(grid, syncs);\n  for (int i = tid; i < owned")]
    sites = [m.group(1) for m in re.finditer(
        r"\b(row_barrier|grid_sync|push_halos|prologue_finish|ksweep_pass<)", loop)]
    assert sites == OUTER_LOOP
    assert "const bool push = set.n > 1 && i % k == 0;" in loop
    assert "if (push) row_barrier(grid, links, ++epoch, syncs, barriers);\n" \
           "    else grid_sync(grid, syncs);" in loop
    assert loop.count("row_barrier(grid, links, ++epoch, syncs, barriers);") == 2
    assert "unsigned long long epoch = links.epoch;" in KERNEL
    body = KERNEL[KERNEL.index("__device__ void row_barrier("):KERNEL.index("// One pass of K")]
    assert body.count("grid_sync(grid, syncs);") == 3   # one card: one; across cards: two
    assert "store_release_sys(links.out[j], epoch);" in body
    assert "while (load_acquire_sys(links.in[j]) < epoch)" in body
    assert "__trap();" in body and "SPIN_LIMIT_NS" in body
    assert "ld.acquire.sys.global.u64" in KERNEL and "st.release.sys.global.u64" in KERNEL
    # the entry point: card c stores into flags[j][c], waits on flags[c][j]
    assert "ln.out[ln.n] = (unsigned long long*)flags[j] + c;" in KERNEL
    assert "ln.in[ln.n] = (const unsigned long long*)flags[c] + j;" in KERNEL


def consecutive(launches, epoch_of):
    """Launches [(cfg, k)] of one row one after another on each card, each
    card's generator going on to the next launch as soon as it ends its
    own; ``epoch_of(flags, i, barriers)`` is the epoch launch i starts from.
    Returns the faults of the flags in every order tried."""
    shard_card = LAYOUTS["4x2dealt"]
    n_y, cards = len(shard_card), 4
    host = RowFlags(flags=[])
    starts = [epoch_of(host, i, row_barriers(cfg, n_y, cards, k))
              for i, (cfg, k) in enumerate(launches)]

    def card(c):   # reads ``row`` as the loop below sets it
        for i, (cfg, k) in enumerate(launches):
            counts = {"syncs": 0, "barriers": 0}
            yield from launch_actor(c, shard_card, cfg, k, row, starts[i], i, counts)
            assert counts["barriers"] == row_barriers(cfg, n_y, cards, k)

    faults = []
    for policy in [first(c) for c in range(cards)] + [seeded(s) for s in range(4)]:
        row = Row(cards)
        try:
            run({c: card(c) for c in range(cards)}, policy)
        except Deadlock as stuck:   # a flag that went back can hide a signal
            row.faults.append(("deadlock", stuck.args[0]))
        faults += row.faults
    return faults


LAUNCHES = [(FlowConfig(outer_iterations_count=3), 1), (FlowConfig(outer_iterations_count=5), 2),
            (FlowConfig(outer_iterations_count=1), 1), (FlowConfig(outer_iterations_count=4), 4)]


def test_epochs_over_consecutive_launches_are_never_stale():
    """RowFlags.advance gives each launch the epochs after the last one's,
    so no wait is satisfied by a flag an earlier launch stored, in any
    order of the cards; restarting every launch at epoch 0 (a reset) lets
    stale flags through, or takes back a signal a card still waits for,
    which the check sees."""
    assert consecutive(LAUNCHES, lambda host, i, n: host.advance(n)) == []
    assert consecutive(LAUNCHES, lambda host, i, n: 0) != []


def test_row_flags_advance():
    host = RowFlags(flags=[])
    cfg = FlowConfig()
    assert row_barriers(cfg, 4, 4) == 80 and row_barriers(cfg, 4, 1) == 0
    assert row_barriers(cfg, 4, 2, 3) == 2 * 14 and row_barriers(cfg, 1, 2) == 0
    assert [host.advance(n) for n in (80, 28, 0, 6)] == [0, 80, 108, 108]
    assert host.epoch == 114
    # each row barrier across cards is two grid syncs around its flag step
    assert grid_syncs(cfg, 4, 1, 4) == grid_syncs(cfg, 4) + 80


def process_emulated(fxyz, uv, sc, cfg, n, k, J=None, policy=None, drop=()):
    """The process mode over ``n`` cards, one shard each: what each card's
    T holds when its launch ends, and each card's counts."""
    shard_card = tuple(range(n))
    work = Work(fxyz, uv, J, sc, cfg, shard_card, k, processes=True)
    row = Row(n)
    counts = [{"syncs": 0, "barriers": 0} for _ in range(n)]
    run({c: launch_actor(c, shard_card, cfg, k, row, 0, 0, counts[c], work, drop, True)
         for c in range(n)}, policy or seeded(0))
    assert row.faults == []
    return work.ended, counts


@pytest.mark.parametrize("constancy", ["grey", "gradient"])
@pytest.mark.parametrize("inner", [1, 5, 7])
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("layout", sorted(PROCESS_LAYOUTS))
def test_process_mode_every_card_ends_with_the_whole_T(layout, k, inner, constancy):
    """Each card copies in from its own fields and stores its owned rows
    into every card's T; after the last row barrier every card's T is
    bitwise relax_sharded and relax, and the counts are the formulas'."""
    n = len(PROCESS_LAYOUTS[layout])
    cfg, uv, fxyz, J, sc = case(min_rows(n, k, inner), WIDTHS[n], n, k, inner, constancy,
                                seed=n * 100 + k * 10 + inner)
    ended, counts = process_emulated(fxyz, uv, sc, cfg, n, k, J,
                                     seeded(n * 1000 + k * 10 + inner))
    Jt = None if J is None else torch.from_numpy(J)
    args = (torch.from_numpy(fxyz), torch.from_numpy(uv), sc, cfg)
    plain = relax_sharded(*args, make_mesh(n, device="cpu"), k, J=Jt).numpy()
    assert plain.tobytes() == relax(*args, J=Jt).numpy().tobytes()
    for T in ended:
        assert T.tobytes() == plain.tobytes()
    for c in counts:
        assert c == {"syncs": grid_syncs(cfg, n, k, n, processes=True),
                     "barriers": row_barriers(cfg, n, n, k, processes=True)}


@pytest.mark.parametrize("layout", ["2procs", "4procs"])
def test_process_mode_last_barrier_is_needed(layout):
    """Without the last row barrier a card can end its launch before
    another card has stored its rows into that card's T: in some order of
    the cards, a card's T then still holds rows not yet written."""
    n = len(PROCESS_LAYOUTS[layout])
    cfg, uv, fxyz, J, sc = case(min_rows(n, 1, 5), 40, n, 1, 5, "grey", seed=9)
    policies = [first(c) for c in range(n)] + [seeded(s) for s in range(3)]
    assert all(np.isfinite(T).all() for T in process_emulated(fxyz, uv, sc, cfg, n, 1)[0])
    assert any(not all(np.isfinite(T).all()
                       for T in process_emulated(fxyz, uv, sc, cfg, n, 1, None, p, ("last",))[0])
               for p in policies)


def test_process_mode_sites_are_the_kernels():
    """The copy-out into every target and the last row barrier over every
    card, read from the kernel and its entry point: each card's copy-in
    reads its own fields, and the last barrier's links are every other
    card's flags, the ones the neighbour barriers use."""
    tail = KERNEL[KERNEL.index("  grid_sync(grid, syncs);\n  for (int i = tid; i < owned"):
                  KERNEL.index("}  // namespace")]
    assert "for (int c = 0; c < out.n; ++c) out.T[c][p * gn + g] = t;" in tail
    assert tail.index("out.T[c]") < tail.index(
        "if (out.n > 1) row_barrier(grid, everyone, ++epoch, syncs, barriers);")
    assert "all.out[all.n] = (unsigned long long*)flags[j] + c;" in KERNEL
    assert "all.in[all.n] = (const unsigned long long*)flags[c] + j;" in KERNEL
    assert "if (n_targets > 1 && j != c) {" in KERNEL
    for field in ("uv", "fxyz"):
        assert f"const float* card_{field} = {field}[c];" in KERNEL
    assert "const float* card_J = J != nullptr ? J[c] : nullptr;" in KERNEL
    assert "if (!(launch >> c & 1u)) continue;" in KERNEL


@pytest.mark.parametrize("processes", [False, True])
def test_counts_in_both_modes(processes):
    """One process: 2 row barriers an exchange across cards, each a sync
    more. Processes: one more row barrier at the end, two syncs more; none
    on a row of one card or one shard."""
    cfg = FlowConfig()
    extra = int(processes)
    assert row_barriers(cfg, 4, 4, processes=processes) == 80 + extra
    assert row_barriers(cfg, 2, 2, 3, processes=processes) == 2 * 14 + extra
    assert row_barriers(cfg, 4, 1, processes=processes) == 0
    assert row_barriers(cfg, 1, 2, processes=processes) == 0
    assert grid_syncs(cfg, 4, 1, 4, processes=processes) == grid_syncs(cfg, 4) + 80 + 2 * extra
    assert grid_syncs(cfg, 4, 1, 1, processes=processes) == grid_syncs(cfg, 4)
    # the two processes on one card of chip_smoke.py's phase 24: 201 + 2, 80 + 1
    assert grid_syncs(models.full_model(), 2, 1, 2, processes=processes) == 201 + 2 * extra


def test_epochs_over_consecutive_launches_of_processes_are_never_stale():
    """RowFlags.advance by the process mode's barriers, its last included,
    over consecutive launches of rows of processes."""
    host = RowFlags(flags=[])
    n = 3
    launches = [(dataclasses.replace(cfg, inner_iterations_count=1), k) for cfg, k in LAUNCHES]
    starts = [host.advance(row_barriers(cfg, n, n, k, processes=True)) for cfg, k in launches]

    def card(c):
        for i, (cfg, k) in enumerate(launches):
            counts = {"syncs": 0, "barriers": 0}
            yield from launch_actor(c, (0, 1, 2), cfg, k, row, starts[i], i, counts,
                                    processes=True)
            assert counts["barriers"] == row_barriers(cfg, n, n, k, processes=True)

    for policy in [first(c) for c in range(n)] + [seeded(s) for s in range(4)]:
        row = Row(n)
        run({c: card(c) for c in range(n)}, policy)
        assert row.faults == []
