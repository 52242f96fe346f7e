"""Port parity of the probe path (ilqgames_tpu_torch/tools, ops/cuda/probes):
the plain versions of the probe kernels P1-P3 against numpy and against the
JAX package on the same numpy operands, at N=11, B=4, C<=3; the registry
against the TPU probe scripts under tools/ (read as text: they reach for a
TPU when imported); and the probe entry points' refusal to measure on a
CPU."""

import ast
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ilqgames_tpu.costs import atoms as jatoms  # noqa: E402
from ilqgames_tpu.dynamics import base as jdyn  # noqa: E402
from ilqgames_tpu.examples import three_player_intersection as jtpi  # noqa: E402
from ilqgames_tpu.ops.pallas import sweep as jsweep  # noqa: E402

from ilqgames_tpu_torch.examples.three_player_intersection import \
    make_problem  # noqa: E402
from ilqgames_tpu_torch.ops.cuda import probes, sweep  # noqa: E402
from ilqgames_tpu_torch.tools import (_probe, kernel_floor,  # noqa: E402
                                      kernel_profile, profile_components,
                                      sweep_floor)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N, B = 11, 4
MODULES = (kernel_floor, sweep_floor, kernel_profile, profile_components)


@pytest.fixture(scope="module")
def games():
    return jtpi.make_problem(num_time_steps=N), make_problem(num_time_steps=N)


def _draws(spec, C, seed=0):
    """Probe-style operands: starts [x, C, B], a random strategy and
    reference trajectory, fixed controls [Pu, B]."""
    X, Pu = spec.xdim, spec.num_players * spec.umax
    rng = np.random.RandomState(seed)
    f = lambda a: a.astype(np.float32)
    return {"x0c": f(rng.randn(X, C, B)), "ufix": 0.01 * f(rng.randn(Pu, B)),
            "Ps": 0.01 * f(rng.randn(N, Pu, X, B)),
            "al": 0.01 * f(rng.randn(N, Pu, B)), "xs": f(rng.randn(N, X, B)),
            "us": 0.01 * f(rng.randn(N, Pu, B)),
            "scal": f(0.5 + 0.1 * rng.rand(C, B)),
            "t0": np.zeros((1, B), np.float32)}


def _port_args(prob, d):
    t = {k: torch.tensor(v) for k, v in d.items()}
    return (prob.dynamics, prob.player_costs, prob.spec, t["x0c"],
            {"xs": t["xs"], "us": t["us"], "t0": t["t0"]},
            {"Ps": t["Ps"], "alphas": t["al"]}, t["scal"]), t


def test_fma_chain_plain_matches_numpy():
    """P1's plain version: the numpy float32 loop, bit for bit; on the CPU
    the wrapper launches nothing."""
    x = np.random.RandomState(0).randn(16, B).astype(np.float32)
    want = x.copy()
    for _ in range(3 * probes.FMA_CHAIN):
        want = want * np.float32(1.000001) + np.float32(0.000001)
    before = probes.fma_chain.launches
    got = probes.fma_chain(make_problem().spec, torch.tensor(x), 3)
    assert probes.fma_chain.launches == before
    np.testing.assert_array_equal(got.numpy(), want)


def test_smoke_plain_is_exact():
    x = np.random.RandomState(0).randn(128, 256).astype(np.float32)
    got = probes.smoke(make_problem().spec, torch.tensor(x))
    np.testing.assert_array_equal(got.numpy(), x * np.float32(2) + 1)


SMOKE_SIZES = [1, 3, 5, 32771]


@pytest.mark.parametrize("n", SMOKE_SIZES)
def test_smoke_plain_matches_numpy_at_odd_sizes(n):
    """P3's plain version against numpy at sizes with a ragged tail; on
    the CPU the wrapper launches nothing."""
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    before = probes.smoke.launches
    got = probes.smoke(make_problem().spec, torch.tensor(x))
    assert probes.smoke.launches == before
    np.testing.assert_array_equal(probes.smoke_plain(torch.tensor(x)).numpy(),
                                  x * np.float32(2) + np.float32(1))
    np.testing.assert_array_equal(got.numpy(), x * np.float32(2) + 1)


def test_smoke_wrapper_refuses_bad_operands():
    spec = make_problem().spec
    with pytest.raises(TypeError, match="float32"):
        probes.smoke(spec, torch.zeros(8, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        probes.smoke(spec, torch.zeros(4, 4).T)
    with pytest.raises(ValueError, match="device"):
        probes.smoke(spec, torch.zeros(8, device="meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SMOKE_SIZES)
def test_smoke_kernel_bitwise_on_card(n):
    """P3 on the card against its plain version, bit for bit, at sizes
    that leave a ragged tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    x = torch.tensor(np.random.RandomState(n).randn(n).astype(np.float32),
                     device="cuda")
    before = probes.smoke.launches
    got = probes.smoke(make_problem().spec, x)
    torch.cuda.synchronize()
    assert probes.smoke.launches == before + 1
    assert torch.equal(got, probes.smoke_plain(x))


@pytest.mark.parametrize("rung,C", [("fixed_u", 1), ("plus", 1),
                                    ("plus", 3)])
def test_floor_rungs_match_jax_integrate(games, rung, C):
    """The kernel_floor rungs (rk4_fixed_u, rk4_feedback and its
    many-candidate form) against the JAX package's RK4, vmapped with the
    probe's law as tools/kernel_floor.py:101-165 writes it."""
    jprob, prob = games
    spec = jprob.spec
    d = _draws(spec, C)
    Pu, X = spec.num_players * spec.umax, spec.xdim

    def integ(t, xx, uu):
        one = lambda tt, x_, u_: jdyn.integrate(jprob.dynamics, tt, spec.dt,
                                                x_, u_)
        inner = jax.vmap(one, in_axes=(None, -1, -1), out_axes=-1)
        return jax.vmap(inner, in_axes=(None, 1, 2), out_axes=1)(t, xx, uu)

    Ps, al, xr = (jnp.asarray(d[k]) for k in ("Ps", "al", "xs"))

    def step(i, x):
        if rung == "fixed_u":
            rows = jnp.broadcast_to(jnp.asarray(d["ufix"])[:, None, :],
                                    (Pu, C, B))
        else:
            P_k, a_k, delta = Ps[i], al[i], x - xr[i][:, None, :]
            rows = []
            for af in range(Pu):
                acc = P_k[af, 0][None, :] * delta[0]
                for xx in range(1, X):
                    acc = acc + P_k[af, xx][None, :] * delta[xx]
                rows.append(acc + a_k[af][None, :])
            rows = jnp.stack(rows, 0)
        return integ(0.1, x, rows.reshape(spec.num_players, spec.umax, C, B))

    want = jax.jit(lambda x: jax.lax.fori_loop(0, N, step, x))(
        jnp.asarray(d["x0c"]))
    args, t = _port_args(prob, d)
    got = probes.probe_rollout(rung, *args, ufix=t["ufix"])["xf"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("rung", ["emit_xs", "emit_xs_us"])
def test_top_rungs_are_rollout_plain(games, rung):
    """P2's emitting rungs are K4: bitwise equal to sweep.rollout_plain on
    a shared start, and the rungs below them carry the same final state."""
    _, prob = games
    d = _draws(prob.spec, 3)
    d["x0c"] = np.ascontiguousarray(np.broadcast_to(d["x0c"][:, :1],
                                                    d["x0c"].shape))
    args, t = _port_args(prob, d)
    got = probes.probe_rollout(rung, *args)
    want = sweep.rollout_plain(prob.dynamics, prob.spec, t["x0c"][:, 0],
                               args[4], args[5], t["scal"], emit_us=True)
    assert torch.equal(got["xs"], want[0])
    if rung == "emit_xs_us":
        assert torch.equal(got["us"], want[1])
    for below in ("prod_table", "lane_t"):
        assert torch.equal(probes.probe_rollout(below, *args)["xf"],
                           got["xf"])


TABLE_RUNGS = [n for n, r in probes.RUNGS.items() if r.merit == "table"]
GATED_RUNGS = [n for n in TABLE_RUNGS if probes.RUNGS[n].gate]


def _merit_operands(prob, gate):
    """Probe operands with one start shared by the candidates (as K5's),
    drawn multipliers, mu 10 and a gate [N, P, B]."""
    d = _draws(prob.spec, 3)
    d["x0c"] = np.ascontiguousarray(np.broadcast_to(d["x0c"][:, :1],
                                                    d["x0c"].shape))
    rng = np.random.RandomState(3)
    d["t0"] = rng.rand(1, B).astype(np.float32)
    args, t = _port_args(prob, d)
    kw = dict(lamS=torch.tensor((0.1 * rng.rand(N, 6, B)).astype(np.float32)),
              mu=torch.full((1, B), 10.0),
              gate=torch.tensor(gate(rng, (N, prob.spec.num_players, B))))
    return args, kw


def _jax_merits(jprob, xs, us, args, kw):
    """The JAX package's _xla_merits on trajectories [N, x, C, B] and
    [N, Pu, C, B], with the probe operands' t0, multipliers, mu and gate."""
    return np.asarray(jsweep._xla_merits(
        jprob.player_costs, jprob.spec, jnp.asarray(xs.numpy()),
        jnp.asarray(us.numpy()), jnp.asarray(args[4]["t0"].numpy()),
        jnp.asarray(kw["lamS"].numpy()), None, jnp.asarray(kw["mu"].numpy()),
        jnp.asarray(kw["gate"].numpy())))


@pytest.mark.parametrize("rung", TABLE_RUNGS)
def test_table_merit_rungs_match_rollout_merits(games, rung):
    """Under a unit gate every table-merit rung (the gate, the knot-0
    select, hoist or multiply, the accumulator in a register or in device
    memory) folds K5's merit: bitwise equal to sweep.rollout_merits_plain
    on the shared start, and to the JAX package's _xla_merits on the
    rolled trajectory within 1e-5."""
    jprob, prob = games
    args, kw = _merit_operands(prob, lambda rng, s: np.ones(s, np.float32))
    got = probes.probe_rollout(rung, *args, **kw)["merit"]
    dyn, costs, spec, x0c, op, st, scal = args
    want = sweep.rollout_merits_plain(dyn, costs, spec, x0c[:, 0], op, st,
                                      scal, kw["lamS"], None, kw["mu"])
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)
    xs, us = sweep.rollout_plain(dyn, spec, x0c[:, 0], op, st, scal,
                                 emit_us=True)
    np.testing.assert_allclose(got.numpy(),
                               _jax_merits(jprob, xs, us, args, kw),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("rung", GATED_RUNGS)
def test_gated_merit_rungs_match_jax(games, rung):
    """A gate in [0.5, 1.5) scales each player's state term per (knot,
    lane) as the JAX package's _xla_merits does with the same gate."""
    jprob, prob = games
    args, kw = _merit_operands(
        prob, lambda rng, s: (0.5 + rng.rand(*s)).astype(np.float32))
    got = probes.probe_rollout(rung, *args, **kw)["merit"]
    top = probes.probe_rollout("emit_xs_us", *args)
    want = _jax_merits(jprob, top["xs"], top["us"], args, kw)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    unit = probes.probe_rollout(
        rung, *args, **{**kw, "gate": torch.ones_like(kw["gate"])})["merit"]
    assert not torch.equal(got, unit)


@pytest.mark.parametrize("rung", ["raw_nomv", "raw_x6"])
def test_raw_merit_rungs_match_numpy(games, rung):
    """The raw-content rungs: the flagship's three nominal-speed gradients
    (100 (x[v] - v_nom))^2, or x[6]^2, folded over knots 1..N-1 in
    ascending order, as a numpy float32 loop over the rolled states."""
    _, prob = games
    args, _ = _port_args(prob, _draws(prob.spec, 3))
    got = probes.probe_rollout(rung, *args)
    xs = probes.probe_rollout("emit_xs", *args)["xs"].numpy()
    f = np.float32
    want = np.zeros(xs.shape[2:], np.float32)
    for k in range(1, N):
        x = xs[k]
        if rung == "raw_nomv":
            g = [f(100) * (x[i] - f(v)) for i, v in ((4, 8.0), (10, 5.0),
                                                     (15, 1.5))]
            s = (g[0] * g[0] + g[1] * g[1]) + g[2] * g[2]
        else:
            s = x[6] * x[6]
        want = want + (f(0) + s)
    np.testing.assert_array_equal(got["merit"].numpy(), want)
    assert torch.equal(got["xf"],
                       probes.probe_rollout("lane_t", *args)["xf"])


def _jax_subset(jcosts, keep):
    """tools/sweep_floor5b.py:169-187 on the JAX package's player costs."""
    return tuple(dataclasses.replace(
        pc,
        state_costs=tuple(c for c in pc.state_costs
                          if keep(pi, "state", c.name)),
        state_constraints=tuple(c for c in pc.state_constraints
                                if keep(pi, "sconstr", c.name)),
        control_costs=tuple((j, c) for j, c in pc.control_costs
                            if keep(pi, "ctrl", c.name)),
        control_constraints=tuple((j, c) for j, c in pc.control_constraints
                                  if keep(pi, "cconstr", c.name)))
        for pi, pc in enumerate(jcosts))


def _jax_lane(jcosts, nseg):
    lane2 = jtpi.lane_polylines()[1][:nseg + 1]
    lane = jatoms.quadratic_polyline2(jtpi.LANE_COST_WEIGHT, lane2, 6, 7,
                                      "LaneCenter")
    return tuple(dataclasses.replace(
        pc, state_costs=(lane,) if pi == 1 else (), state_constraints=(),
        control_costs=(), control_constraints=())
        for pi, pc in enumerate(jcosts))


@pytest.mark.parametrize("subset", ["lane", "nomv", "ctrl", "prox", "lane2",
                                    "seg1", "seg2", "player1"])
def test_subtable_merits_match_jax(games, subset):
    """The merit over a cost sub-table (the content the K5 rows of the
    registry run) against the JAX package's `_xla_merits` with the same
    filtered player costs, on the same trajectories and multipliers."""
    jprob, prob = games
    spec = prob.spec
    if subset.startswith("seg"):
        pcs, rows = (_probe.truncated_lane_costs(prob.player_costs,
                                                 int(subset[3:])), [])
        jpcs = _jax_lane(jprob.player_costs, int(subset[3:]))
    else:
        pcs, rows = _probe.player_costs_subset(prob.player_costs,
                                               sweep_floor.SUBSETS[subset])
        jpcs = _jax_subset(jprob.player_costs, sweep_floor.SUBSETS[subset])
    assert [len(pc.state_constraints) for pc in pcs] == \
        [len(pc.state_constraints) for pc in jpcs]
    X, P = spec.xdim, spec.num_players
    Pu, C = P * spec.umax, 3
    rng = np.random.RandomState(1)
    xs = (3.0 * rng.randn(N, X, C, B)).astype(np.float32)
    us = (0.3 * rng.randn(N, Pu, C, B)).astype(np.float32)
    lam = (0.1 * rng.rand(N, 6, B)).astype(np.float32)[:, rows]
    lam = np.ascontiguousarray(lam) if rows else None
    t0 = np.zeros((1, B), np.float32)
    mu = np.full((1, B), 10.0, np.float32)
    got = sweep.merit_plain(pcs, spec, torch.tensor(xs), torch.tensor(us),
                            torch.tensor(t0),
                            None if lam is None else torch.tensor(lam), None,
                            torch.tensor(mu))
    want = jsweep._xla_merits(jpcs, jprob.spec, jnp.asarray(xs),
                              jnp.asarray(us), jnp.asarray(t0),
                              None if lam is None else jnp.asarray(lam),
                              None, jnp.asarray(mu),
                              jnp.ones((N, P, B), jnp.float32))
    assert np.isfinite(np.asarray(want)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_player_costs_subset_rows(games):
    """The kept constraint rows index the full lamS in player order."""
    _, prob = games
    rows = lambda name: _probe.player_costs_subset(
        prob.player_costs, sweep_floor.SUBSETS[name])[1]
    assert rows("full") == list(range(6))
    assert rows("prox") == list(range(6))
    assert rows("player1") == [2, 3]
    assert rows("prox_p1_p3") == [3]
    assert rows("lane") == []


def test_rung_table_matches_source():
    """ops/cuda/probes.py RUNGS and csrc/probes.cu PROBE_RUNGS list the
    same instantiations."""
    src = (REPO / "ilqgames_tpu_torch/csrc/probes.cu").read_text()
    rows = re.findall(r"^\s*R\((\d+), (\w+), (\w+), (\d), (\w+), (\w+), "
                      r"(\d), (\w+), (\w+)\)", src, re.M)
    got = sorted((int(i), lay.lower(), law.lower(), bool(int(lt)),
                  em.lower(), me.lower(), bool(int(g)), k0.lower(),
                  acc.lower())
                 for i, lay, law, lt, em, me, g, k0, acc in rows)
    want = sorted(dataclasses.astuple(r) for r in probes.RUNGS.values())
    assert got == want
    assert [r.id for r in probes.RUNGS.values()] == list(range(len(rows)))
    assert len({probes.template_args(r) for r in probes.RUNGS.values()}) \
        == len(rows)


def _tpu_docstring_cases(path):
    """The case names a TPU probe script's docstring lists: indented lines
    that start with a name followed by two spaces or ' - '."""
    doc = ast.get_docstring(ast.parse(path.read_text())) or ""
    return {m.group(1) for m in re.finditer(
        r"^ {2,}([a-z][a-z0-9_]*)(?: {2,}| - )", doc, re.M)}


def test_registry_covers_every_tpu_probe():
    """Every pl.pallas_call launch line under tools/ is some row's
    `replaces`, and every case its script's docstring lists has a row
    there (by name or alias)."""
    cases = [c for m in MODULES for c in m.CASES]
    by_site = {}
    for c in cases:
        by_site.setdefault(c.replaces, set()).update(
            (c.key.split(".", 1)[1],) + c.aliases)
    sites = []
    for path in sorted((REPO / "tools").glob("*.py")):
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if "pallas_call(" in line:
                sites.append((path, f"tools/{path.name}:{i}"))
    assert len(sites) == 13
    for path, site in sites:
        assert site in by_site, site
        missing = _tpu_docstring_cases(path) - by_site[site]
        assert not missing, (site, missing)
    assert len(_tpu_docstring_cases(REPO / "tools/sweep_floor5.py")) == 6
    assert set(by_site) == {site for _, site in sites}


def test_float_ops_counts_the_plain_arithmetic():
    """float_ops counts one operation per float32 output element of the
    arithmetic (per input element of a reduction), and nothing for
    selects, compares, sign flips, copies or float64 work."""
    x = torch.tensor(np.random.RandomState(0).randn(16, B).astype(np.float32))
    out, n = _probe.float_ops(lambda: probes.fma_chain_plain(x, 3))
    assert torch.equal(out, probes.fma_chain_plain(x, 3))
    assert n == x.numel() * 3 * probes.FMA_CHAIN * 2
    assert _probe.float_ops(lambda: probes.smoke_plain(x))[1] == 2 * x.numel()
    assert _probe.float_ops(lambda: x.sum(0) / 3.0)[1] == x.numel() + B
    assert _probe.float_ops(lambda: torch.where(
        x > 0, -x, (x.double() * 2.0).float()))[1] == 0


def test_registry_launches_carry_plain_versions():
    """Every call of the registries that is one kernel launch carries its
    plain version and a (kernel, cost table, shape) key; `checks` yields
    each key once, and every K5 cost sub-table is among them. On the CPU
    a call's wrapper takes the plain version itself, so there the kept
    plain rollout of the K4 and K5 rows must give the same bits."""
    ctx = _probe.Context("cpu")
    chains = {"merit_plain", "K4 -> K6", "3 x K5", "K4 + sum"}
    cases = [c for m in (kernel_floor, sweep_floor, kernel_profile)
             for c in m.CASES]
    keys = set()
    for case in cases:
        for call in case.run(ctx):
            assert (call.plain is None) == (call.label in chains), \
                (case.key, call.label)
            if call.plain is not None:
                keys.add(call.key)
    calls = list(_probe.checks(cases, ctx, set()))
    assert sorted(c.key for c in calls) == sorted(keys)
    assert {k[0] for k in keys} == {"P1", "P2", "K4", "K5", "K6"}
    assert {k[1] for k in keys if k[0] == "K5"} == (
        set(sweep_floor.SUBSETS) - {"empty"} | {"seg1", "seg2", "seg6"})
    for kern, emit in (("K5", None), ("K4", True)):
        call = next(c for c in calls if c.key[0] == kern
                    and (emit is None or c.key[1] == emit))
        for got, want in zip(_flat(call.fn()), _flat(call.plain())):
            assert torch.equal(got, want), call.key


def _flat(result):
    return result if isinstance(result, tuple) else (result,)


def test_probe_entry_points_need_cuda():
    """A probe run with no CUDA device raises; it never measures on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    for mod in MODULES:
        with pytest.raises(RuntimeError, match="CUDA"):
            mod.main()


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card(games):
    """P1, every P2 rung and P3 on the card against their plain versions,
    bit for bit, with a non-uniform gate and t0 (scal differs per
    candidate and lane already), so that a rung reading a wrong entry of
    them disagrees."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke.py)")
    _, prob = games
    d = _draws(prob.spec, 3)
    d["t0"] = np.random.RandomState(2).rand(1, B).astype(np.float32)
    args, t = _port_args(prob, d)
    cu = lambda v: ({k: a.cuda() for k, a in v.items()}
                    if isinstance(v, dict) else
                    v.cuda() if isinstance(v, torch.Tensor) else v)
    lam = torch.rand((N, 6, B))
    kw = dict(ufix=t["ufix"], gate=0.5 + torch.rand((N, 3, B)), lamS=lam,
              mu=torch.full((1, B), 10.0))
    for rung in probes.RUNGS:
        want = probes.probe_rollout(rung, *args, **kw)
        got = probes.probe_rollout(rung, *map(cu, args),
                                   **{k: cu(v) for k, v in kw.items()})
        for key, w in want.items():
            assert torch.equal(got[key].cpu(), w), (rung, key)
    x = torch.tensor(d["x0c"][:, 0])
    assert torch.equal(probes.fma_chain(prob.spec, x.cuda(), 3).cpu(),
                       probes.fma_chain_plain(x, 3))
    assert torch.equal(probes.smoke(prob.spec, x.cuda()).cpu(),
                       probes.smoke_plain(x))
