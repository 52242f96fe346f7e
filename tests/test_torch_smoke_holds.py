"""chip_smoke.py's holds of the replanning path's launches: the spy that
keeps a copy of each kernel's first launch at each shape, the shapes it
keys them by and the bytes it bounds them with. On the CPU the wrappers
launch nothing, so a stand-in that counts a launch as the CUDA path does
takes K4's place."""

import importlib.util
import inspect
import types
from pathlib import Path

import numpy as np
import torch

from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem
from ilqgames_tpu_torch.ops.cuda import sweep

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _wrappers(cs):
    return {name: getattr(importlib.import_module(
        f"ilqgames_tpu_torch.ops.cuda.{mod}"), attr)
        for name, (mod, attr, *_) in cs.KERNEL_SITES.items()}


def _k4_operands(C, B, N=5):
    problem = make_problem(num_time_steps=N)
    spec = problem.spec
    x, Pu = spec.xdim, spec.num_players * spec.umax
    rng = np.random.RandomState(0)
    t = lambda *s: torch.tensor(0.1 * rng.standard_normal(s),
                                dtype=torch.float32)
    return (problem.dynamics, spec, t(x, B),
            {"xs": t(N, x, B), "us": t(N, Pu, B), "t0": t(1, B)},
            {"Ps": t(N, Pu, x, B), "alphas": t(N, Pu, B)}, t(C, B))


def test_first_launches_spies_on_every_wrapper_and_restores_it():
    cs = _chip_smoke()
    before = _wrappers(cs)
    assert set(before) == {"K1", "K2", "K3", "K4", "K5", "K6", "K7"}
    with cs._FirstLaunches():
        during = _wrappers(cs)
        assert all(during[k] is not before[k] for k in before)
    assert _wrappers(cs) == before


def test_spy_keeps_a_copy_of_the_first_launch_at_each_shape():
    cs = _chip_smoke()

    def stand_in(dyn, spec, x0m, op_bm, st_bm, scal_cb, emit_us=False):
        stand_in.launches += 1
        return sweep.rollout_plain(dyn, spec, x0m, op_bm, st_bm, scal_cb,
                                   emit_us)

    stand_in.launches = 0
    spy = cs._FirstLaunches()
    sig = inspect.signature(sweep.rollout_bm)
    k4 = spy._spy("K4", stand_in, sig)
    args = _k4_operands(C=2, B=3)
    k4(*args)
    xs, us = k4(*args, emit_us=True)
    k4(*args[:5], scal_cb=args[5], emit_us=True)
    assert dict(spy.tally) == {("K4", "C=2, B=3"): 1,
                               ("K4", "C=2, B=3, emit_us"): 2}
    assert cs._k4_shape(2, 3, True) == "C=2, B=3, emit_us"
    kept = spy.seen[("K4", "C=2, B=3, emit_us")]
    assert kept["emit_us"] is True
    assert kept["x0m"] is not args[2] and torch.equal(kept["x0m"], args[2])
    args[2].add_(1.0)                  # the caller's tensor moves on
    assert not torch.equal(kept["x0m"], args[2])
    # The kept arguments replay the launch, by parameter name.
    xs2, us2 = sweep.rollout_plain(**kept)
    assert torch.equal(xs2, xs) and torch.equal(us2, us)
    # Bytes: x0m, the operating point without t0, the strategy, the
    # scalings and the outputs, each once.
    N, x, Pu, C, B = 5, 16, 6, 2, 3
    want = 4 * (x * B + N * x * B + N * Pu * B + N * Pu * x * B
                + N * Pu * B + C * B + N * x * C * B + N * Pu * C * B)
    assert cs._launch_bytes("K4", kept, [xs, us]) == want


def test_spy_keeps_nothing_where_the_wrapper_launched_nothing():
    """On CPU tensors the real K4 wrapper takes its plain version and
    adds no launch; the spy then keeps and counts nothing."""
    cs = _chip_smoke()
    spy = cs._FirstLaunches()
    k4 = spy._spy("K4", sweep.rollout_bm, inspect.signature(sweep.rollout_bm))
    k4(*_k4_operands(C=1, B=2), emit_us=True)
    assert not spy.tally and not spy.seen


def test_a_wrapper_counting_on_its_module_name_counts_on_itself():
    """The kernel wrappers count on their module's name for themselves
    (`rollout_bm.launches += 1`); while a spy stands in that name, the
    count and `by_shape` still land on the wrapper, and the spy sees
    the launch."""
    cs = _chip_smoke()
    module = types.ModuleType("wrapper_module")
    exec("import collections\n"
         "def k4(dyn, spec, x0m, op_bm, st_bm, scal_cb, emit_us=False):\n"
         "    k4.launches += 1\n"
         "    k4.by_shape[tuple(scal_cb.shape) + (emit_us,)] += 1\n"
         "    return x0m\n"
         "k4.launches = 0\n"
         "k4.by_shape = collections.Counter()\n", module.__dict__)
    wrapper = module.k4
    spy = cs._FirstLaunches()
    module.k4 = spy._spy("K4", wrapper, inspect.signature(wrapper))
    args = _k4_operands(C=1, B=4)
    module.k4(*args, emit_us=True)
    module.k4(*args, emit_us=True)
    assert wrapper.launches == 2 and module.k4.launches == 2
    assert dict(wrapper.by_shape) == {(1, 4, True): 2}
    assert dict(spy.tally) == {("K4", "C=1, B=4, emit_us"): 2}
    module.k4.launches = 0             # a reset reaches the wrapper too
    assert wrapper.launches == 0


def test_split_hands_over_what_was_seen_and_starts_anew():
    """A run's load and its timed run are held as two cells: `split`
    returns the launches seen so far and the spy goes on from nothing."""
    cs = _chip_smoke()

    def stand_in(dyn, spec, x0m, op_bm, st_bm, scal_cb, emit_us=False):
        stand_in.launches += 1
        return sweep.rollout_plain(dyn, spec, x0m, op_bm, st_bm, scal_cb,
                                   emit_us)

    stand_in.launches = 0
    spy = cs._FirstLaunches()
    k4 = spy._spy("K4", stand_in, inspect.signature(sweep.rollout_bm))
    k4(*_k4_operands(C=1, B=2))
    load = spy.split()
    k4(*_k4_operands(C=1, B=3))
    k4(*_k4_operands(C=1, B=3))
    assert dict(load.tally) == {("K4", "C=1, B=2"): 1}
    assert set(load.seen) == {("K4", "C=1, B=2")}
    assert dict(spy.tally) == {("K4", "C=1, B=3"): 2}
    assert set(spy.seen) == {("K4", "C=1, B=3")}


def test_only_the_rollouts_are_held_on_a_prefix():
    """The cells' K2 (and K1, K3, K6) are held at the cell's depth; only
    K4 and K5, whose plain versions take seconds a call at N=100, on the
    first HOLD_DEPTH knots."""
    cs = _chip_smoke()
    assert cs.PREFIX_KERNELS == ("K4", "K5")
    assert cs.HOLD_DEPTH < 100


def test_k7_launches_are_keyed_and_bounded():
    """K7 (the open-loop LQ sweep) is spied on through its module's name,
    which the open-loop solve calls it by; its launches are keyed by B,
    and bounded by what it reads (Qf and lf at every knot, A, Bf, Rf and
    rf but at the last, dx0) and writes (alphas, dxs), each once."""
    from ilqgames_tpu_torch.examples import dubins_origin
    from ilqgames_tpu_torch.ops.cuda import lq, lq_open_loop
    from ilqgames_tpu_torch.solver import lq_open_loop as solver
    from ilqgames_tpu_torch.types import LinearDynamics, QuadraticCosts

    cs = _chip_smoke()
    spec = dubins_origin.make_problem(num_time_steps=5).spec
    N, P, x, u, Bt = 5, 2, 6, 1, 3
    rng = np.random.RandomState(1)
    t = lambda *s: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
    lin = LinearDynamics(A=t(Bt, N, x, x), Bs=t(Bt, N, P, x, u))
    spd = torch.eye(x).expand(Bt, N, P, x, x).contiguous()
    quad = QuadraticCosts(Q=spd, l=t(Bt, N, P, x),
                          R=torch.eye(u).expand(Bt, N, P, P, u, u) + 0.0,
                          r=t(Bt, N, P, P, u))

    def stand_in(spec, ops, dx0):
        stand_in.launches += 1
        return lq_open_loop.lq_open_loop_plain(spec, ops, dx0)

    stand_in.launches = 0
    spy = cs._FirstLaunches()
    saved = lq_open_loop.lq_open_loop
    lq_open_loop.lq_open_loop = spy._spy(
        "K7", stand_in, inspect.signature(saved))
    try:
        sol = solver.solve_lq_open_loop(spec, lin, quad, t(Bt, x),
                                        batch_block=4)
    finally:
        lq_open_loop.lq_open_loop = saved
    assert dict(spy.tally) == {("K7", "B=4"): 1}
    kept = spy.seen[("K7", "B=4")]
    out = lq_open_loop.lq_open_loop_plain(**kept)
    assert torch.equal(out[0][:, :, :Bt].permute(2, 0, 1).reshape(
        Bt, N - 1, P, u), sol.strategy.alphas[:, :-1])
    B, Pu = 4, P * u
    ops = lq.lq_operands(spec, lin, quad, 4)
    assert set(kept["ops"]) == set(ops)
    want = 4 * B * (N * P * x * x + N * P * x + (N - 1) * (
        x * x + x * Pu + P * P * u * u + P * P * u) + x
        + (N - 1) * Pu + N * x)
    assert cs._launch_bytes("K7", kept, list(out)) == want



def test_phase_1_builds_every_later_library_once(tmp_path, monkeypatch):
    """Phase 1 builds the libraries of phases 8-12 with the flagship's:
    the driving games' (the roundabout's K2 at 4 lanes a block, its K1 and
    K6 for a table of 48 atoms, the modified intersection's K1 with
    car_5d's Jacobian) among them; a library that two games share (the
    flat game's K2 is the flagship's) is one nvcc process."""
    from ilqgames_tpu_torch.ops.cuda import build, lq

    cs = _chip_smoke()
    libs = cs._later_libraries()
    flagship = lq.library(make_problem().spec)
    assert flagship in libs
    runs = []

    class Nvcc:
        def __init__(self, cmd, **kwargs):
            runs.append(cmd)
            Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
            self.returncode = 0

        def communicate(self):
            return "", ""

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_target", lambda n, d: (
        Path(n), [], tmp_path / f"lib{n}_{hash(tuple(sorted(d.items())))}"))
    monkeypatch.setattr(build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", Nvcc)
    build.compile_all([flagship] + libs)
    keys = {(n, tuple(sorted(d.items()))) for n, d in [flagship] + libs}
    assert len(runs) == len(keys) < len(libs) + 1
    lq_g = {d["LQ_X"]: d["LQ_G"] for n, d in libs if n == "lq"}
    assert lq_g[24] == 4 and lq_g[18] == 8
    assert ("stage", {"ST_X": 24, "ST_P": 4, "ST_U": 2, "CT_SEMI": 1,
                      "CT_MAX_ATOMS": 48}) in libs
    assert ("merit", {"MR_X": 24, "MR_P": 4, "MR_U": 2, "CT_SEMI": 1,
                      "CT_MAX_ATOMS": 48}) in libs
    assert ("stage", {"ST_X": 14, "ST_P": 3, "ST_U": 2, "CT_SEMI": 1,
                      "CT_CAR5D": 1}) in libs


def test_phase_6_holds_the_registry_on_a_prefix():
    """The probe registry's holds run on a context whose spec and drawn
    operands end after P2_DEPTH knots; the draws stay the TPU scripts'."""
    from ilqgames_tpu_torch.tools import _probe

    cs = _chip_smoke()
    cut = cs._knots_cut(_probe, "cpu", cs.P2_DEPTH)
    full = _probe.Context("cpu")
    assert cut.spec.num_time_steps == cs.P2_DEPTH < _probe.N_KNOTS
    draw = lambda: _probe.floor_draws(full.spec, 8, 16)
    got, want = cut.tensors("floor", draw), full.tensors("floor", draw)
    for k, v in want.items():
        if v.ndim >= 2 and v.shape[0] == _probe.N_KNOTS:
            assert torch.equal(got[k], v[:cs.P2_DEPTH])
        else:
            assert torch.equal(got[k], v)


def test_phase_12_golden_bounds_and_cpu_jobs():
    """The driving games' golden runs are held with
    tests/test_golden_more.py's bounds on the reference's files (N=100,
    every player's position columns); the CPU side of every card-vs-CPU
    check is a job the worker pool can run, keyed as the phases ask for
    it, and computed in the caller's process where no pool runs it."""
    cs = _chip_smoke()
    bounds = {run: (n, bound, conv) for run, (_, n, bound, conv)
              in cs.DRIVING_GOLDEN.items()}
    assert bounds == {"overtaking": (3, 0.01, True),
                      "roundabout": (4, 0.3, False)}
    for path, n, _, _ in cs.DRIVING_GOLDEN.values():
        assert np.loadtxt(REPO / path).shape == (100, 6 * n)
    jobs = cs._cpu_jobs()
    keys = [(fn.__name__, *args) for fn, *args in jobs]
    assert len(keys) == len(set(keys))
    assert ("_cpu_trips", ("config", "roundabout"), "roundabout",
            True) in keys
    x0, carries, _ = cs._cpu_job(cs._cpu_trips, ("example", "skeleton"),
                                 "small", True)
    assert x0.shape == (cs.SMALL_B, 4) and len(carries) == cs.SMALL_TRIPS + 1


def _plain_calls(n):
    """(plain version, arguments by name) of every kernel's plain version
    at N = n on seeded operands: the one-player reachability game (its
    control multipliers and extremal gate) for K1, K4-K6, its LQ operands
    for K2, K3 and K7, and the flagship's state multipliers for K5."""
    import ilqgames_tpu_torch.examples as ex
    from ilqgames_tpu_torch.ops.cuda import lq, lq_open_loop, stage

    rng = np.random.RandomState(1)
    t = lambda *s: torch.tensor(0.3 * rng.standard_normal(s),
                                dtype=torch.float32)
    calls = []
    for name in ("one_player_reachability", "three_player_intersection"):
        prob = ex.get(name)(num_time_steps=n)
        dyn, costs, spec = prob.dynamics, prob.player_costs, prob.spec
        x, P, u, B, C = spec.xdim, spec.num_players, spec.umax, 4, 2
        op = {"xs": prob.x0[None, :, None] + t(n, x, B).cumsum(0),
              "us": t(n, P * u, B), "t0": t(1, B)}
        st = {"Ps": t(n, P * u, x, B), "alphas": t(n, P * u, B)}
        nS = sum(len(pc.state_constraints) for pc in costs)
        nC = sum(len(pc.control_constraints) for pc in costs)
        lamS = t(n, nS, B).abs() if nS else None
        lamC = t(n, nC, B).abs() if nC else None
        gate = (None if name == "three_player_intersection"
                else torch.eye(n)[:, None, :B].expand(n, P, B).contiguous())
        mu = torch.full((1, B), 10.0)
        scal = torch.full((C, B), 0.5)
        x0m = prob.x0[:, None] + t(x, B)
        ops = stage.lin_quad_plain(dyn, costs, spec, op, lamS, lamC, mu,
                                   gate)
        Ps, al = lq.lq_backward_plain(spec, ops)
        xs = sweep.rollout_plain(dyn, spec, x0m, op, st, scal)
        us = sweep._us_from_xs(spec, xs, op, st, scal)
        merit = dict(player_costs=costs, spec=spec, lamS=lamS, lamC=lamC,
                     mu=mu, gate=gate)
        calls += [
            (stage.lin_quad_plain, dict(dyn=dyn, player_costs=costs,
                                        spec=spec, op_bm=op, lamS=lamS,
                                        lamC=lamC, mu=mu, gate=gate)),
            (lq.lq_backward_plain, dict(spec=spec, ops=ops, adaptive=True)),
            (lq.lq_forward_plain, dict(spec=spec, A=ops["A"], Bf=ops["Bf"],
                                       alphas=al, dx0=t(x, B))),
            (lq_open_loop.lq_open_loop_plain, dict(spec=spec, ops=ops,
                                                   dx0=t(x, B))),
            (sweep.rollout_plain, dict(dyn=dyn, spec=spec, x0m=x0m,
                                       op_bm=op, st_bm=st, scal_cb=scal,
                                       emit_us=True)),
            (sweep.rollout_merits_plain, dict(merit, dyn=dyn, x0m=x0m,
                                              op_bm=op, st_bm=st,
                                              scal_cb=scal)),
            (sweep.merit_plain, dict(merit, xs_cand=xs, us_cand=us,
                                     t0_bm=op["t0"]))]
    return calls


def test_operation_counts_carried_from_a_few_knots_are_exact():
    """`_count_ops` (the counts on the first 1, 2 and 3 knots, carried to
    the call's depth) equals the count at the call's depth for every
    kernel's plain version, at N = 11."""
    from ilqgames_tpu_torch.tools._probe import float_ops

    cs = _chip_smoke()
    for plain, a in _plain_calls(11):
        full = float_ops(lambda: plain(**a))[1]
        assert full > 0
        assert cs._count_ops(plain, a) == full, plain.__name__


def test_phase_1_builds_the_zoo_libraries_once():
    """Phase 1 builds phase 17's libraries with the others: the fused zoo
    game's K1, K6 and K5 with CT_ZOO (the last two with CT_NORMS, for
    quadratic_norm), its K2/K3 and K4 the flagship's; the unfused game's
    K2/K3 and K4 the flagship's too (its dense-only constraints leave it
    no K1, K5 or K6), so that it adds no library."""
    from ilqgames_tpu_torch import bench

    cs = _chip_smoke()
    libs = cs._later_libraries()
    fused, unfused = cs.zoo_problem(True), cs.zoo_problem(False)
    flag = bench.kernel_libraries(make_problem().dynamics,
                                  make_problem().spec)
    zf = bench.kernel_libraries(fused.dynamics, fused.spec,
                                fused.player_costs)
    zu = bench.kernel_libraries(unfused.dynamics, unfused.spec,
                                unfused.player_costs)
    assert all(lib in libs for lib in zf + zu)
    assert [d.get("CT_ZOO") for _, d in zf] == [1, None, 1, None, 1]
    assert zf[2][1].get("CT_NORMS") == zf[-1][1].get("CT_NORMS") == 1
    assert zf[1] == flag[1] and zf[3] == flag[3]
    assert zu == [flag[1], flag[3]]
    new = [lib for lib in zf if lib not in (flag[1], flag[3])]
    assert len(new) == 3 and all(libs.count(lib) == 1 for lib in new)


def test_phase_17_holds_every_launch(monkeypatch):
    """Phase 17 holds every (kernel, shape) each zoo cell launched (its
    spy handed to `_hold_launches` with the cell's launches, K4's shapes
    checked against the wrapper's count), K5 and K6 at the fused cell's
    linesearch shapes and at the unfused cell's on its atoms (without the
    dense-only constraints), and the trips card vs CPU of both games,
    the unfused one under "xla" only."""
    from ilqgames_tpu_torch import bench

    cs = _chip_smoke()
    calls = []

    def cell(name, problem, fused, dev):
        spy = types.SimpleNamespace(seen={}, tally={}, name=name)
        launches = {"K1": int(fused), "K2": 1, "K3": 1, "K4": 1}
        calls.append(("cell", name, fused))
        return None, {}, launches, spy

    monkeypatch.setattr(cs, "_zoo_cell", cell)
    monkeypatch.setattr(cs, "_ptxas", lambda *a, **k: {})
    monkeypatch.setattr(bench, "build_kernels", lambda *a, **k: None)
    monkeypatch.setattr(cs, "_check_k4_held", lambda c, spy, by: calls.append(
        ("k4", c, spy.name)))
    monkeypatch.setattr(cs, "_hold_launches", lambda c, spy, launches: (
        calls.append(("hold", c, spy.name, dict(launches))) or [c]))
    monkeypatch.setattr(cs, "_hold_merits", lambda c, spy, p, full=True: (
        calls.append(("merits", c, spy.name, full, sum(
            not con.al_quad_pairs_fn for pc in p.player_costs
            for con in pc.state_constraints))) or [c]))
    monkeypatch.setattr(cs, "_trips_card_vs_cpu", lambda name, game, cfg,
                        fuse, dev, backends=("xla", "kernel", "pallas"): (
        calls.append(("trips", name, game, fuse, backends)) or [name]))
    entries = cs.phase17("cpu")
    f, u = (f"{g}_{cs.ZOO_B}" for g in cs.ZOO_GAMES)
    assert ("cell", f, True) in calls and ("cell", u, False) in calls
    for c in (f, u):
        assert ("k4", c, c) in calls
        assert any(k[:3] == ("hold", c, c) for k in calls)
    assert ("merits", f, f, True, 0) in calls
    assert ("merits", f"{u}'s atoms", u, False, 0) in calls
    assert ("trips", cs.ZOO_GAMES[0], ("zoo", True), True,
            ("xla", "kernel", "pallas")) in calls
    assert ("trips", cs.ZOO_GAMES[1], ("zoo", False), False,
            ("xla",)) in calls
    assert len(entries) == 6
    jobs = {(fn.__name__, *args) for fn, *args in cs._cpu_jobs()}
    assert ("_cpu_trips", ("zoo", True), "small", True) in jobs
    assert ("_cpu_trips", ("zoo", False), "small", False) in jobs


def test_zoo_operation_counts_carried_from_a_few_knots_are_exact():
    """`_count_ops` is exact for the plain versions of K1 and K6 on the
    zoo games (the new pieces' operations do not depend on the data)."""
    from ilqgames_tpu_torch.ops.cuda import stage
    from ilqgames_tpu_torch.tools._probe import float_ops

    cs = _chip_smoke()
    n, B = 11, 4
    rng = np.random.RandomState(2)
    t = lambda *s: torch.tensor(0.3 * rng.standard_normal(s),
                                dtype=torch.float32)
    for fused in (True, False):
        prob = cs.zoo_problem(fused, n)
        costs, spec = prob.player_costs, prob.spec
        x, P, u = spec.xdim, spec.num_players, spec.umax
        nS = sum(len(pc.state_constraints) for pc in costs)
        op = {"xs": prob.x0[None, :, None] + t(n, x, B).cumsum(0),
              "us": t(n, P * u, B), "t0": t(1, B)}
        lamS, mu = t(n, nS, B).abs(), torch.full((1, B), 10.0)
        xs = op["xs"][:, :, None].contiguous()
        calls = [(sweep.merit_plain, dict(
            player_costs=costs, spec=spec, xs_cand=xs,
            us_cand=op["us"][:, :, None].contiguous(), t0_bm=op["t0"],
            lamS=lamS, lamC=None, mu=mu, gate=None))]
        if fused:
            calls.append((stage.lin_quad_plain, dict(
                dyn=prob.dynamics, player_costs=costs, spec=spec, op_bm=op,
                lamS=lamS, lamC=None, mu=mu, gate=None)))
        for plain, a in calls:
            full = float_ops(lambda: plain(**a))[1]
            assert full > 0
            assert cs._count_ops(plain, a) == full, plain.__name__


def test_cpu_jobs_split_between_the_two_processes():
    """Each CPU job goes to one process's workers, in the order of all of
    them: the second process's are those of its phases (12-15 and 17),
    the script's the others; phases 2 and 6, which time their kernels
    with the card alone, stay in the script's process."""
    cs = _chip_smoke()
    key = lambda jobs: [(fn.__name__, *args) for fn, *args in jobs]
    every = key(cs._cpu_jobs())
    second = key(cs._cpu_jobs(cs.SECOND_PHASES))
    own = key(cs._cpu_jobs(set(range(18)) - set(cs.SECOND_PHASES)))
    assert sorted(second + own, key=repr) == sorted(every, key=repr)
    assert [k for k in every if k in second] == second
    assert [k for k in every if k in own] == own
    assert ("_cpu_trips", ("config", "roundabout"), "roundabout",
            True) in second
    assert ("_cpu_trips", ("zoo", False), "small", False) in second
    assert ("_cpu_cli", cs.CLI_HELD_RH) in own
    assert ("_cpu_flagship_trips", False) in own
    assert not {2, 6} & set(cs.SECOND_PHASES)


def test_holds_time_their_kernel_later_while_deferred(monkeypatch):
    """While deferring, a hold's entry keeps its kernel call, which
    `_time_later` times (each call with its own arguments) and rounds as
    `_entry` does; otherwise the kernel is timed at once."""
    cs = _chip_smoke()
    calls = []
    monkeypatch.setattr(cs, "_time_ms", lambda fn, reps, warm_s=0.2: (
        fn(), 0.123456 * len(calls))[1])
    now = cs._entry("K2 now", "s", "r", 0.0, cs._hold_ms(
        lambda: calls.append("now")), 1.0, 8, 1)
    assert now["ms"] == 0.1235 and calls == ["now"]
    cs._LATER["defer"] = True
    later = [cs._entry(f"K4 {i}", "s", "r", 0.0, cs._hold_ms(
        lambda i=i: calls.append(i)), 1.0, 8, 1) for i in range(2)]
    assert calls == ["now"]
    assert all(isinstance(e["ms"], cs._Later) for e in later)
    cs._time_later([now] + later)
    assert calls == ["now", 0, 1] and not cs._LATER["defer"]
    assert [e["ms"] for e in later] == [0.2469, 0.3704]
    assert now["ms"] == 0.1235


def test_a_timed_run_has_the_card_alone():
    """`_Pair`: while one process runs alone (a timed cell), the other
    stands at a pause point, and a process waiting at a pause point or
    for a CPU job lets the other run alone; both asking at once run one
    after the other. Two threads stand in for the two processes."""
    import multiprocessing
    import threading
    import time

    cs = _chip_smoke()
    ctx = multiprocessing.get_context("spawn")
    alone, a_busy, b_busy = ctx.Lock(), ctx.Lock(), ctx.Lock()
    a_busy.acquire()
    b_busy.acquire()
    deadline = time.time() + 20.0           # a deadlock fails, not hangs
    a = cs._Pair(alone, a_busy, b_busy, lambda: time.time() < deadline)
    b = cs._Pair(alone, b_busy, a_busy, lambda: time.time() < deadline)
    log = []

    def run(pair, name, n, every):
        for i in range(n):
            log.append(name)
            if i % 7 == 3:
                assert pair.pause(lambda: time.sleep(0.002) or i) == i
            else:
                pair.pause()
            if i % every == 0:
                with pair.alone():
                    log.append(name.upper() + "[")
                    with pair.alone():          # nested: the outer one's
                        pair.pause()            # no pause point inside
                        time.sleep(0.02)
                    log.append("]" + name.upper())
        pair.done()

    other = threading.Thread(target=run, args=(b, "b", 120, 40))
    other.start()
    run(a, "a", 90, 30)
    other.join(30)
    assert not other.is_alive()
    assert log.count("A[") == 3 and log.count("B[") == 3
    inside = None
    for entry in log:
        if entry.endswith("["):
            assert inside is None
            inside = entry[0]
        elif entry.startswith("]"):
            assert inside == entry[1]
            inside = None
        else:
            assert inside is None, (entry, "ran while the other was alone")
