"""The launch geometry of the wavefront kernels K2 / K3 and their probe,
on the CPU: ``wavefront_kernels.launch_geometry`` (the one function that
sizes every clustered launch) with made-up resident-cluster counts, and
the row-to-CTA schedule it implies (``row_schedule`` below, the mirror of
``bwwf::Wave::row_at`` in csrc/wavefront.cuh), simulated MB by MB with the
kernels' waits: the row above past MB x + 1 (x + 2 in progress), and,
inside a cluster, the ring of the CTA below free again before the CTA
above pushes a later row into it. Every case must run to its end, and the
first row of every picture must wait for nothing. No card is needed."""

import pytest

from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW

HEIGHTS = list(range(1, 18)) + [68, 135]
BATCHES = range(1, 9)
RESIDENT = (1, 2, 3, 5, 124)        # clusters the card holds, made up
W = 3                               # MBs a row: enough for x + 2 waits


def row_schedule(cluster: int, grid: int, rows: int) -> list:
    """The rows each CTA of a launch takes, in the order it takes them:
    CTA rank r of cluster k owns row (k + i * clusters) * C + r for i = 0,
    1, ... below `rows` (``bwwf::Wave::row_at`` in csrc/wavefront.cuh)."""
    clusters = grid // cluster
    out = []
    for cta in range(grid):
        k, rank = divmod(cta, cluster)
        mine, i = [], 0
        while (k + i * clusters) * cluster + rank < rows:
            mine.append((k + i * clusters) * cluster + rank)
            i += 1
        out.append(mine)
    return out


def _simulate(h: int, batch: int, cluster: int, resident: int,
              max_ctas: int = 0) -> int:
    """Run the schedule of one launch to its end; returns the rounds it
    took. Raises AssertionError on a deadlock or a broken invariant."""
    rows = batch * h
    C, clusters, grid = KW.launch_geometry(rows, resident, cluster, max_ctas)
    assert C == cluster and grid == clusters * C
    assert 1 <= clusters <= resident and clusters <= -(-rows // C)
    if max_ctas:
        assert grid <= max(C, max_ctas - max_ctas % C)
    sched = row_schedule(C, grid, rows)
    taken = sorted(r for mine in sched for r in mine)
    assert taken == list(range(rows)), "every row exactly once"
    for mine in sched:
        assert mine == sorted(mine), "a CTA takes its rows in order"

    def waits_on(r):
        """The row r waits on, or None: the first row of a picture."""
        return None if r % h == 0 else r - 1

    for b in range(batch):
        assert waits_on(b * h) is None
    progress = [0] * rows              # MBs done a row
    pos = [0] * grid                   # index of each CTA's current row
    consumed = [0] * grid              # ring rows a CTA has read (below)
    pushed = [0] * grid                # ring rows a CTA has filled (above)
    started = [False] * rows
    rounds = 0
    active = [c for c in range(grid) if sched[c]]
    while active:
        moved = False
        for c in active:
            r = sched[c][pos[c]]
            rank = c % C
            down = rank + 1 < C and r + 1 < rows and (r + 1) % h != 0
            if not started[r]:
                # a CTA pushes a later row only once the CTA below has
                # read the earlier one's ring
                if down and consumed[c + 1] < pushed[c]:
                    continue
                started[r] = True
            x = progress[r]
            up = waits_on(r)
            if up is not None and progress[up] < min(x + 2, W):
                continue
            progress[r] = x + 1
            moved = True
            if progress[r] == W:
                pos[c] += 1
                if down:
                    pushed[c] += 1
                if rank > 0 and up is not None:
                    consumed[c] += 1
        active = [c for c in active if pos[c] < len(sched[c])]
        rounds += 1
        assert moved or not active, (
            f"deadlock: h={h} batch={batch} C={C} clusters={clusters}")
    return rounds


@pytest.mark.parametrize("cluster", [1, 8, 16])
@pytest.mark.parametrize("h", HEIGHTS)
def test_schedule_finishes_and_first_rows_wait_for_nothing(h, cluster):
    for batch in BATCHES:
        for resident in RESIDENT:
            _simulate(h, batch, cluster, resident)


@pytest.mark.parametrize("max_ctas", [1, 5, 8, 12, 16, 20, 40])
def test_capped_grid_is_whole_clusters(max_ctas):
    for h in (3, 7, 17):
        for batch in (1, 3, 8):
            _simulate(h, batch, 8, 124, max_ctas)
            C, clusters, grid = KW.launch_geometry(batch * h, 124, 8,
                                                   max_ctas)
            assert grid % 8 == 0
            assert clusters == min(-(-batch * h // 8), max(1, max_ctas // 8))


def test_geometry_at_1080p_and_4k():
    assert KW.launch_geometry(68, 30) == (8, 9, 72)
    assert KW.launch_geometry(135, 30) == (8, 17, 136)
    assert KW.launch_geometry(4 * 68, 30) == (8, 30, 240)    # strides
    assert KW.launch_geometry(1, 30) == (8, 1, 8)
    assert KW.launch_geometry(68, 30, cluster=1) == (1, 30, 30)


def test_geometry_refuses_what_cannot_launch():
    with pytest.raises(RuntimeError):
        KW.launch_geometry(68, 0)          # no cluster fits: raise
    with pytest.raises(ValueError):
        KW.launch_geometry(0, 30)
    with pytest.raises(ValueError):
        KW.launch_geometry(68, 30, cluster=17)


def test_set_max_ctas_is_a_python_cap():
    old = KW.set_max_ctas(12)
    try:
        assert KW.set_max_ctas(12) == 12
        assert KW._max_ctas == 12
    finally:
        KW.set_max_ctas(old)
    assert KW._max_ctas == old


def test_design_probes_need_a_card(capsys):
    """tools.wavefront_designs measures only on a card: without one it
    runs nothing and exits 2."""
    import torch

    from broadway_tpu_torch.tools import wavefront_designs
    if torch.cuda.is_available():
        pytest.skip("a card is present: the probes would run")
    assert wavefront_designs.main(["probes"]) == 2
    assert "no CUDA card" in capsys.readouterr().err
