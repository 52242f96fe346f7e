"""The per-instance entry points on the card (marker `cuda`; they skip
without a CUDA device) and the pieces of `chip_smoke.py`'s phase 16 that
run without one. This file imports no JAX: the card's machine has none.

On the card, each entry point is held against the same call on the CPU
(the kernels' plain versions): the same bits, as chip_smoke.py's phase 16
holds the CLI's simulators, at N=11 with small budgets.
"""

import contextlib
import io

import pytest
import torch

import chip_smoke
import ilqgames_tpu_torch.examples as examples
from ilqgames_tpu_torch import bench, cli
from ilqgames_tpu_torch.runtime import receding_horizon as rh
from ilqgames_tpu_torch.solver.params import SolverParams

SMALL = SolverParams(max_solver_iters=4, unconstrained_solver_max_iters=2,
                     max_backtracking_steps=20, initial_alpha_scaling=0.1,
                     convergence_tolerance=1.0,
                     expected_decrease_fraction=0.001)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card via chip_smoke.py)")
    return torch.device("cuda")


def _same_bits(a, b):
    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def test_phase_16_commands():
    """The simulators run CLI_REPLANS cycles over CLI_FINAL_TIME at 20
    iterations a solve; the held runs are the same commands (the same
    budgets) over CLI_HELD_TIME, CLI_HELD_CYCLES cycles, each a CPU job
    of the pool, started after phase 3's and before every other job."""
    assert int(float(chip_smoke.CLI_FINAL_TIME) / 0.25) - 1 == \
        chip_smoke.CLI_REPLANS == 3
    assert int(float(chip_smoke.CLI_HELD_TIME) / 0.25) - 1 == \
        chip_smoke.CLI_HELD_CYCLES == 2
    for argv in (chip_smoke.CLI_RH, chip_smoke.CLI_MI):
        assert argv[-2:] == ("--max_solver_iters", "20")
    parse = cli.build_parser().parse_args
    for timed, held in ((chip_smoke.CLI_RH, chip_smoke.CLI_HELD_RH),
                        (chip_smoke.CLI_MI, chip_smoke.CLI_HELD_MI)):
        a = vars(parse(timed + ("--final_time",
                                chip_smoke.CLI_FINAL_TIME)))
        h = vars(parse(held))
        assert h.pop("final_time") == float(chip_smoke.CLI_HELD_TIME)
        a.pop("final_time")
        assert a == h
    assert parse(chip_smoke.CLI_HELD_MI).safety_example == \
        "three_player_intersection_reachability"
    assert parse(chip_smoke.CLI_HELD_RH).receding_horizon
    jobs = chip_smoke._cpu_jobs()
    assert {jobs[2][1], jobs[3][1]} == {chip_smoke.CLI_HELD_RH,
                                        chip_smoke.CLI_HELD_MI}
    for argv in (chip_smoke.CLI_HELD_RH, chip_smoke.CLI_HELD_MI):
        assert (chip_smoke._cpu_cli, argv) in jobs
        hash((chip_smoke._cpu_cli.__name__, argv))  # a job's key


def test_cli_run_prints_and_returns_the_lines(capsys):
    run, lines, secs, stats = chip_smoke._cli_run(("--list",), "cpu")
    assert lines == examples.names() and len(lines) == 18
    assert capsys.readouterr().out.splitlines() == lines
    assert run == {} and stats is None and secs >= 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["solve", "solve_unconstrained",
                                   "solve_logged"])
def test_entry_points_on_card_match_cpu(entry):
    dev = _card()
    prob = examples.get("three_player_intersection")(num_time_steps=11)
    got = getattr(prob, entry)(SMALL, device=dev)
    want = getattr(prob, entry)(SMALL, device="cpu")
    if entry == "solve_logged":
        (got, log), (want, wlog) = got, want
        assert log.num_iterates == wlog.num_iterates
        assert _same_bits(torch.from_numpy(log.final_operating_point.xs),
                          got.op.xs)
        for a, b in zip(got.history[1:], want.history[1:]):
            a, b = (a.xs, b.xs) if hasattr(a, "xs") else (a, b)
            a, b = (a.alphas, b.alphas) if hasattr(a, "alphas") else (a, b)
            assert torch.equal(a.cpu(), b) if a.dtype == torch.bool \
                else _same_bits(a, b)
    assert got.op.xs.device.type == "cuda"
    assert _same_bits(got.op.xs, want.op.xs)
    assert torch.equal(got.converged.cpu(), want.converged)


@pytest.mark.cuda
def test_simulators_on_card_match_cpu():
    dev = _card()
    prob = examples.get("three_player_intersection")(num_time_steps=11)
    got = rh.simulate(prob, SMALL, final_time=0.75, device=dev)
    want = rh.simulate(prob, SMALL, final_time=0.75, device="cpu")
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    orig = examples.get("modified_three_player_intersection")(
        num_time_steps=11)
    safety = examples.get("three_player_intersection_reachability")(
        num_time_steps=11)
    got = rh.simulate_minimally_invasive(orig, safety, SMALL,
                                         final_time=0.75, device=dev)
    want = rh.simulate_minimally_invasive(orig, safety, SMALL,
                                          final_time=0.75, device="cpu")
    assert _same_bits(got[0], want[0])
    assert torch.equal(got[2].cpu(), want[2])


@pytest.mark.cuda
def test_cli_on_card_launches_the_kernels():
    _card()
    bench.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(["--num_time_steps", "11", "--max_solver_iters",
                         "4", "--device", "cuda"]) == 0
    assert out.getvalue().startswith("Solver completed in ")
    launches = bench.launches()
    assert min(launches[k] for k in ("K1", "K2", "K3", "K4")) > 0, launches
    bench.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["--example", "dubins_origin", "--open_loop",
                         "--num_time_steps", "11", "--max_solver_iters",
                         "4", "--device", "cuda"]) == 0
    launches = bench.launches()
    assert launches["K7"] > 0 and launches["K1"] == 0, launches
