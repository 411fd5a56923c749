"""A Python mirror of the fused masked attention's schedule
(qnnpack_tpu_torch/kernels/csrc/q8attn_masked.cu, q8bmm_masked_kernel):
the four head warpgroups, free-running, and the ring of kSlots slots, each
with a full, a vfull and an empty mbarrier, whose copies start kLead
iterations ahead.

Each warpgroup is a generator that follows the kernel's main loop step for
step; a scheduler runs them (and lands each warpgroup's share of a slot's
copies at a moment of its choosing) in many random and two fixed orders.
The mbarriers behave as the card's do: a wait on a parity returns once
the phase of that parity has completed.  The mirror checks that no order
deadlocks, that every wait targets the phase it means (never one behind
or two ahead), that each slot is filled once a use and never refilled
before all four warpgroups released it, that every read of a slot (by the
scores, the transposition and the context, from issue to wait) sees the
copies of its own iteration, that each warpgroup visits every (sweep, key
tile) once, in order, and that no warpgroup issues its products more than
2 kLead + 1 steps (32 keys each) ahead of the slowest: at (it, 0) it has
waited for iteration it's copies, which every warpgroup issued at
(it - kLead, 0).  The ring lets them run apart without a block-wide
barrier, and bounds how far.  The constants
are read from the kernel's source, so the mirror follows it."""

import random
import re
from pathlib import Path

import pytest

SOURCE = (Path(__file__).resolve().parents[1] / "qnnpack_tpu_torch" /
          "kernels" / "csrc" / "q8attn_masked.cu")
HEADS = 4
WG_THREADS, WG_WARPS = 128, 4


def constants():
    text = SOURCE.read_text()
    out = {}
    for name in ("kHeads", "kSlots", "kLead", "kKeys", "kRows"):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m, f"{name} not found in {SOURCE.name}"
        out[name] = int(m.group(1))
    return out


def tiles(kind, n, keys=64, rows=64):
    """(u0, ntiles) as the kernel computes them for a block whose key tiles
    are n: causal rows m0 = 64 (n - 1), or a band whose first tile is 2."""
    if kind == "causal":
        m0, window, s = rows * (n - 1), 0, 1 << 15
    else:
        m0, window, s = rows * (n + 1), keys * (n - 1) + 1, 1 << 15
    lo_key = max(0, m0 - window + 1) if window else 0
    u0 = lo_key // keys
    ntiles = min(m0 + rows - 1, s - 1) // keys - u0 + 1
    return u0, ntiles


class MBarrier:
    def __init__(self, count):
        self.count, self.pending, self.phase = count, count, 0

    def arrive(self, n):
        self.pending -= n
        assert self.pending >= 0
        if self.pending == 0:
            self.pending, self.phase = self.count, self.phase + 1

    def passes(self, n):
        """try_wait.parity(n & 1): true once the current phase's parity
        differs; the wait must mean phase n, so the barrier has completed
        n or n + 1 phases (else the parity names another phase)."""
        assert n <= self.phase <= n + 1, (n, self.phase)
        return (self.phase & 1) != (n & 1)


class Block:
    """One block's shared state: barriers, the slots' contents, the log."""

    def __init__(self, c, u0, ntiles):
        self.c, self.u0, self.ntiles = c, u0, ntiles
        self.iters = 3 * ntiles
        ks = c["kSlots"]
        self.full = [MBarrier(HEADS * WG_THREADS) for _ in range(ks)]
        self.vfull = [MBarrier(HEADS * WG_WARPS) for _ in range(ks)]
        self.empty = [MBarrier(HEADS * WG_WARPS) for _ in range(ks)]
        # Per slot and warpgroup share: the iteration whose bytes it holds.
        self.k = [[None] * HEADS for _ in range(ks)]
        self.raw = [[None] * HEADS for _ in range(ks)]
        self.vt = [[None] * HEADS for _ in range(ks)]
        self.fills = [[] for _ in range(ks)]       # iterations, in order
        self.released = {}                        # iteration -> warpgroups
        self.landing = []                         # copies in flight
        self.steps = [0] * HEADS                  # products issued
        self.max_spread = 0
        self.visits = [[] for _ in range(HEADS)]
        self.at_sync = 0                          # prologue barrier

    def load(self, w, j):
        """Warpgroup w's share of iteration j's copies, in flight."""
        s = j % self.c["kSlots"]
        if j >= self.c["kSlots"]:
            assert self.released.get(j - self.c["kSlots"]) == set(
                range(HEADS)), f"slot {s} refilled for {j} before release"
        if w == 0:
            self.fills[s].append(j)
        self.landing.append((w, j))

    def land(self, idx):
        w, j = self.landing.pop(idx)
        s = j % self.c["kSlots"]
        self.k[s][w] = j
        if j >= 2 * self.ntiles:
            self.raw[s][w] = j
        self.full[s].arrive(WG_THREADS)

    def holds(self, part, j):
        s = j % self.c["kSlots"]
        assert part[s] == [j] * HEADS, (j, part[s])


def warpgroup(blk, w):
    """The kernel's control flow for warpgroup w (its four warps as one);
    yields a predicate where the kernel would wait (True: a moment at
    which others may run)."""
    c, iters, nt = blk.c, blk.iters, blk.ntiles
    ks, lead = c["kSlots"], c["kLead"]
    for j in range(min(lead, iters)):
        blk.load(w, j)
    blk.at_sync += 1
    yield lambda: blk.at_sync == HEADS
    phase, u = 0, 0
    for it in range(iters):
        slot = it % ks
        n = it // ks
        yield lambda: blk.full[slot].passes(n)
        for half in range(2):
            if phase == 2 and half == 1:
                nv = (it - 2 * nt) // ks
                yield lambda: blk.vfull[slot].passes(nv)
            # The scores, and from the third sweep on the previous 32
            # keys' context: this tile's first half or the last tile's
            # second.
            reads = [(blk.k, it)]
            if phase == 2 and (half == 1 or it > 2 * nt):
                reads.append((blk.vt, it if half == 1 else it - 1))
            for part, j in reads:
                blk.holds(part, j)
            blk.steps[w] += 1
            blk.max_spread = max(blk.max_spread,
                                 blk.steps[w] - min(blk.steps))
            assert blk.steps[w] - min(blk.steps) <= 2 * lead + 1, blk.steps
            yield lambda: True
            if half == 0:
                j = it + lead
                if j < iters:
                    if j >= ks:
                        ne = j // ks - 1
                        yield lambda: blk.empty[j % ks].passes(ne)
                    blk.load(w, j)
                if it + 1 < iters and it + 1 >= 2 * nt:
                    s1, n1 = (it + 1) % ks, (it + 1) // ks
                    yield lambda: blk.full[s1].passes(n1)
                    blk.holds(blk.raw, it + 1)
                    blk.vt[s1][w] = it + 1
                    blk.vfull[s1].arrive(WG_WARPS)
            yield lambda: True
            for part, j in reads:     # the products are done: wgmma_wait
                blk.holds(part, j)
            if half == 0 and it > 0:
                blk.released.setdefault(it - 1, set()).add(w)
                blk.empty[(it - 1) % ks].arrive(WG_WARPS)
            blk.visits[w].append((phase, blk.u0 + u, half))
        last = u + 1 == nt
        phase += last
        u = 0 if last else u + 1
    blk.holds(blk.vt, iters - 1)     # the last 32 keys' context


def run(c, u0, ntiles, seed, policy="random"):
    rng = random.Random(seed)
    blk = Block(c, u0, ntiles)
    agents = {w: warpgroup(blk, w) for w in range(HEADS)}
    waiting = {w: (lambda: True) for w in agents}
    while agents or blk.landing:
        ready = [w for w in agents if waiting[w]()]
        moves = [("wg", w) for w in ready] + \
                [("land", i) for i in range(len(blk.landing))]
        assert moves, f"deadlock: {sorted(agents)} waiting"
        if policy == "random":
            kind, x = rng.choice(moves)
        elif policy == "late_copies":   # land copies only when stuck
            kind, x = moves[0] if ready else moves[-1]
        else:                           # "eager": the last warpgroup first
            kind, x = moves[-1]
        if kind == "land":
            blk.land(x)
            continue
        try:
            waiting[x] = next(agents[x])
        except StopIteration:
            del agents[x], waiting[x]
    return blk


CONSTANTS = constants()


@pytest.mark.parametrize("kind", ["causal", "band"])
@pytest.mark.parametrize("n", range(1, 10))
def test_ring_mirrors_the_kernel(kind, n):
    c = CONSTANTS
    assert c["kHeads"] == HEADS
    u0, ntiles = tiles(kind, n, c["kKeys"], c["kRows"])
    assert ntiles == n and (u0 > 0) == (kind == "band")
    iters = 3 * ntiles
    want = [(ph, u0 + u, half) for ph in range(3) for u in range(ntiles)
            for half in range(2)]
    spread = 0
    for seed, policy in [(s, "random") for s in range(40)] + \
            [(0, "late_copies"), (0, "eager")]:
        blk = run(c, u0, ntiles, seed, policy)
        # Every warpgroup visits every (sweep, key tile, half) once, in
        # order.
        assert blk.visits == [want] * HEADS
        # Every slot filled once a use, in order of its iterations.
        for s in range(c["kSlots"]):
            assert blk.fills[s] == list(range(s, iters, c["kSlots"]))
        assert blk.steps == [2 * iters] * HEADS
        spread = max(spread, blk.max_spread)
    # The orders tried do run the warpgroups apart.
    assert spread >= min(2 * iters - 1, 3)


def test_mirror_catches_a_ring_too_shallow():
    """With one slot fewer than kLead + 2, a warpgroup's refill waits for
    its own release of the slot, still ahead of it: the mirror finds the
    deadlock (its checks are not vacuous)."""
    c = dict(CONSTANTS, kSlots=CONSTANTS["kLead"] + 1)
    with pytest.raises(AssertionError, match="deadlock"):
        run(c, 0, 5, 0)
