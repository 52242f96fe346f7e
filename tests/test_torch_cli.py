"""The port's command line (`python -m ilqgames_tpu_torch`,
`ilqgames_tpu_torch/cli.py`) against the JAX package's
(`ilqgames_tpu/cli.py`), in-process on the CPU (`--device cpu`).

- `--list`: the same 18 names.
- The flagship at N=11 (the exec main's flags, budgets cut to
  tests/test_torch_receding_horizon.py's) with `--check_nash`: the same
  lines in the same order; the solve (Problem.solve, the AL machine) with
  the same converged flag and iterations, the violation and the costs
  within the per-trip class (2e-3), the same Nash verdict.
- `skeleton` at N=11 with `--save` and `--html`: the same lines (paths
  aside), the saved logs' files with the same values within 2e-3, and the
  HTML pages' embedded data within 2e-3 (their numbers are rounded to 3
  and 5 decimals).
- `--receding_horizon` on `skeleton`: the same lines, the final state
  within 2e-3.
- `--batch`, `--safety_example` and `--viz` on the port alone: the JAX
  line's fields; the JAX line's format; a PNG, and a plain ImportError
  where matplotlib is missing.
- `--device cuda` (the default) without a card raises: no fallback.
"""

import contextlib
import io
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from ilqgames_tpu import cli as jcli
from ilqgames_tpu_torch import cli

torch.set_num_threads(1)

TRIP_TOL = 2e-3
BUDGETS = ["--max_solver_iters", "12", "--unconstrained_solver_max_iters",
           "5", "--max_backtracking_steps", "20"]
SOLVED = re.compile(r"Solver completed in [0-9.]+ seconds \(converged="
                    r"(True|False), iterations=(\d+), max constraint "
                    r"violation=(\S+)\)\.")


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def _floats(line):
    return np.array([float(v) for v in
                     re.findall(r"-?\d+\.?\d*(?:e[-+]?\d+)?|-?inf", line)])


def _same_solve_lines(got, want):
    g, w = SOLVED.fullmatch(got[0]), SOLVED.fullmatch(want[0])
    assert g and w, (got[0], want[0])
    assert g.group(1, 2) == w.group(1, 2)
    np.testing.assert_allclose(float(g.group(3)), float(w.group(3)),
                               rtol=TRIP_TOL, atol=TRIP_TOL)
    assert got[1].startswith("Total costs: [")
    np.testing.assert_allclose(_floats(got[1]), _floats(want[1]),
                               rtol=TRIP_TOL, atol=TRIP_TOL)


def test_list_matches_jax():
    names = _run(cli.main, ["--list"])
    assert names == _run(jcli.main, ["--list"])
    assert len(names) == 18


def test_flagship_lines_match_jax():
    argv = ["--num_time_steps", "11", "--check_nash"] + BUDGETS
    got = _run(cli.main, argv + ["--device", "cpu"])
    want = _run(jcli.main, argv)
    assert len(got) == len(want) == 3
    _same_solve_lines(got, want)
    assert got[2] == want[2]
    res = cli.main.last_run["result"]
    assert res.op.xs.shape == (11, 16) and res.op.xs.device.type == "cpu"


@pytest.fixture(scope="module")
def skeleton_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    argv = ["--example", "skeleton", "--num_time_steps", "11", "--save",
            "--max_solver_iters", "20"]
    out = {}
    for name, main, extra in (("port", cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, [])):
        out[name] = _run(main, argv + extra + [
            "--experiment_name", str(d / name),
            "--html", str(d / f"{name}.html")])
    return d, out


def test_skeleton_lines_match_jax(skeleton_runs):
    d, out = skeleton_runs
    got, want = out["port"], out["jax"]
    assert len(got) == len(want) == 4
    _same_solve_lines(got, want)
    assert got[2:] == [f"Saved HTML animation to {d / 'port.html'}",
                       f"Saved log to {d / 'port'}"]
    assert want[2:] == [f"Saved HTML animation to {d / 'jax.html'}",
                        f"Saved log to {d / 'jax'}"]


def test_saved_log_matches_jax(skeleton_runs):
    d, _ = skeleton_runs
    files = lambda base: sorted(
        os.path.relpath(os.path.join(r, f), base)
        for r, _, fs in os.walk(base) for f in fs)
    got = files(d / "port")
    assert got == files(d / "jax") and got
    for f in got:
        np.testing.assert_allclose(np.loadtxt(d / "port" / f),
                                   np.loadtxt(d / "jax" / f),
                                   rtol=TRIP_TOL, atol=TRIP_TOL, err_msg=f)


def _html_data(path):
    text = open(path).read()
    return json.loads(re.search(r"const D = (.*);\n", text).group(1))


def _same_data(got, want, where=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), where
        for k in want:
            _same_data(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list) and want and not isinstance(
            want[0], (int, float)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same_data(g, w, f"{where}[{i}]")
    elif isinstance(want, bool):
        assert got == want, where
    else:
        np.testing.assert_allclose(np.asarray(got, float),
                                   np.asarray(want, float), rtol=TRIP_TOL,
                                   atol=TRIP_TOL, err_msg=where)


def test_html_matches_jax(skeleton_runs):
    d, _ = skeleton_runs
    _same_data(_html_data(d / "port.html"), _html_data(d / "jax.html"))


def test_receding_horizon_lines_match_jax():
    argv = ["--example", "skeleton", "--num_time_steps", "11",
            "--receding_horizon", "--final_time", "0.75",
            "--max_solver_iters", "2"]
    got = _run(cli.main, argv + ["--device", "cpu"])
    want = _run(jcli.main, argv)
    pattern = re.compile(r"Simulated (\S+) s of sim time \((\d+) replans\) "
                         r"in [0-9.]+ s wall\.")
    assert pattern.fullmatch(got[0]).group(1, 2) == \
        pattern.fullmatch(want[0]).group(1, 2) == ("0.50", "2")
    assert got[1].startswith("Final state: [")
    np.testing.assert_allclose(_floats(got[1]), _floats(want[1]),
                               rtol=TRIP_TOL, atol=TRIP_TOL)


def test_batch_line():
    """The JAX CLI's --batch fields, here from the batched machine on one
    device: the same draw (RandomState(0), sigma 0.1)."""
    from ilqgames_tpu_torch import bench
    from ilqgames_tpu_torch.solver import batched
    from ilqgames_tpu_torch.solver.params import SolverParams
    import ilqgames_tpu_torch.examples as examples

    argv = ["--example", "skeleton", "--num_time_steps", "11",
            "--max_solver_iters", "5", "--batch", "3", "--device", "cpu"]
    (line,) = _run(cli.main, argv)
    out = json.loads(line)
    assert list(out) == ["example", "batch", "wall_s", "num_converged",
                         "max_violation"]
    prob = examples.get("skeleton")(num_time_steps=11)
    params = SolverParams(max_solver_iters=5, max_backtracking_steps=100,
                          initial_alpha_scaling=0.1,
                          convergence_tolerance=1.0,
                          expected_decrease_fraction=0.001)
    res = batched.make_host_batched_solver(
        prob.dynamics, prob.player_costs, prob.spec, params)(
            torch.tensor(bench.perturbed_x0(prob, 3)))
    assert out["example"] == "skeleton" and out["batch"] == 3
    assert out["num_converged"] == int(res.converged.sum())
    assert out["max_violation"] == float(res.max_violation.max())
    assert torch.equal(cli.main.last_run["batch"].op.xs, res.op.xs)


def test_safety_example_line():
    argv = ["--example", "modified_three_player_intersection",
            "--safety_example", "three_player_intersection_reachability",
            "--num_time_steps", "5", "--final_time", "0.75",
            "--max_solver_iters", "1", "--unconstrained_solver_max_iters",
            "1", "--device", "cpu"]
    (line,) = _run(cli.main, argv)
    m = re.fullmatch(r"Simulated 0\.50 s \(2 replans, safety controller "
                     r"active (\d)x\) in [0-9.]+ s wall\.", line)
    assert m, line
    flags = cli.main.last_run["simulation"][2]
    assert int(m.group(1)) == int(flags.sum()) and flags.shape == (2,)


def test_viz(tmp_path, monkeypatch):
    """--viz saves a PNG with matplotlib, and without it raises a plain
    ImportError (it never skips)."""
    argv = ["--example", "skeleton", "--num_time_steps", "5",
            "--max_solver_iters", "2", "--viz", "--device", "cpu",
            "--experiment_name", str(tmp_path / "plot")]
    # Blocked only within this context: the modules that matplotlib had
    # loaded stay as they were, for the tests after this one.
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "matplotlib", None)
        with pytest.raises(ImportError, match="--viz needs matplotlib"):
            _run(cli.main, argv)
    pytest.importorskip("matplotlib")
    lines = _run(cli.main, argv)
    assert lines[-1] == f"Saved plot to {tmp_path / 'plot'}.png"
    assert (tmp_path / "plot.png").stat().st_size > 0


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--example", "skeleton", "--num_time_steps", "5"])
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["--example", "skeleton", "--device", "cuda:0"])
