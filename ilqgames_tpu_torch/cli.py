"""Command-line entry point (counterpart of ilqgames_tpu/cli.py), mirroring
the reference exec binaries (exec/*/main.cpp, SURVEY.md §2.12): pick an
example, set solver flags, solve, run Nash checks, optionally save the
log and render a plot or a scrubable HTML page.

    python -m ilqgames_tpu_torch --example three_player_intersection --save
    python -m ilqgames_tpu_torch --list
    python -m ilqgames_tpu_torch --device cpu --num_time_steps 11

The JAX package's flags, defaults and printed lines, and one more flag,
--device: "cuda" (the default) runs every solve on the card and fails
where none is present; "cpu" runs the kernels' plain versions on the CPU,
only when asked. --batch N solves N perturbed instances (RandomState(0),
sigma 0.1) on the batched machine on the one card. After a call,
`main.last_run` holds what the run computed, by name ("result",
"log_result", "log", "simulation", "batch"), for a caller that drives
the CLI in-process.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="ilqgames_tpu_torch",
        description="N-player differential game solver (PyTorch + CUDA)",
    )
    p.add_argument("--example", default="three_player_intersection",
                   help="example problem name (see --list)")
    p.add_argument("--list", action="store_true", help="list examples")
    # Reference exec flags (exec/three_player_intersection/main.cpp:64-78).
    p.add_argument("--open_loop", action="store_true",
                   help="use open-loop (vs feedback) solver")
    p.add_argument("--no_linesearch", action="store_true")
    p.add_argument("--initial_alpha_scaling", type=float, default=0.1)
    p.add_argument("--convergence_tolerance", type=float, default=1.0)
    p.add_argument("--expected_decrease", type=float, default=0.001)
    p.add_argument("--max_solver_iters", type=int, default=100)
    p.add_argument("--unconstrained_solver_max_iters", type=int, default=10)
    p.add_argument("--max_backtracking_steps", type=int, default=100)
    p.add_argument("--save", action="store_true", help="save solver log")
    p.add_argument("--experiment_name", default=None)
    p.add_argument("--html", default=None, metavar="PATH",
                   help="write a scrubable HTML animation of the solve "
                        "(iterate + time sliders; the reference GUI's "
                        "capability as a headless artifact)")
    p.add_argument("--viz", action="store_true",
                   help="save a top-down trajectory plot (PNG; needs "
                        "matplotlib)")
    p.add_argument("--check_nash", action="store_true",
                   help="run the numerical local-Nash check")
    p.add_argument("--batch", type=int, default=0,
                   help="solve a batch of perturbed instances at once")
    p.add_argument("--num_time_steps", type=int, default=None)
    # Receding-horizon mode (reference exec/receding_horizon_example).
    p.add_argument("--receding_horizon", action="store_true",
                   help="run the fixed-cadence receding-horizon simulator")
    p.add_argument("--safety_example", default=None,
                   help="run the minimally-invasive dual-solver simulator "
                        "with this example as the safety problem "
                        "(e.g. three_player_intersection_reachability)")
    p.add_argument("--final_time", type=float, default=10.0)
    p.add_argument("--replan_interval", type=float, default=0.25)
    p.add_argument("--planner_runtime", type=float, default=0.25)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a CUDA device) or "
                        "cpu (the kernels' plain versions)")
    return p


def _sync(dev) -> None:
    """Wait for the card, so that a host clock read after it times the
    work and not its enqueue."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None):
    args = build_parser().parse_args(argv)

    import ilqgames_tpu_torch.examples as examples

    main.last_run = {}
    if args.list:
        for name in examples.names():
            print(name)
        return 0

    import numpy as np
    import torch

    from ilqgames_tpu_torch.problem import device_of
    from ilqgames_tpu_torch.solver.params import SolverParams

    try:
        dev = device_of(args.device)
    except RuntimeError as e:
        raise SystemExit(f"ilqgames_tpu_torch: {e}") from e
    params = SolverParams(
        open_loop=args.open_loop,
        linesearch=not args.no_linesearch,
        initial_alpha_scaling=args.initial_alpha_scaling,
        convergence_tolerance=args.convergence_tolerance,
        expected_decrease_fraction=args.expected_decrease,
        max_solver_iters=args.max_solver_iters,
        unconstrained_solver_max_iters=args.unconstrained_solver_max_iters,
        max_backtracking_steps=args.max_backtracking_steps,
    )
    problem = examples.get(args.example)(num_time_steps=args.num_time_steps)

    if args.batch:
        from ilqgames_tpu_torch.solver import batched

        problem.prepare(params, dev)
        rng = np.random.RandomState(0)
        x0 = np.tile(problem.x0.numpy()[None], (args.batch, 1))
        x0 += 0.1 * rng.randn(*x0.shape).astype(np.float32)
        x0 = torch.tensor(x0, device=dev)
        solver = batched.make_host_batched_solver(
            problem.dynamics, problem.player_costs, problem.spec, params,
            warm_op=problem.initial_operating_point(),
            warm_strategy=problem.initial_strategy())
        _sync(dev)
        t0 = time.perf_counter()
        res = solver(x0)
        _sync(dev)
        dt = time.perf_counter() - t0
        main.last_run = {"batch": res, "stats": solver.last_stats}
        print(json.dumps({
            "example": args.example,
            "batch": args.batch,
            "wall_s": round(dt, 3),
            "num_converged": int(res.converged.sum()),
            "max_violation": float(res.max_violation.max()),
        }))
        return 0

    if args.safety_example:
        from ilqgames_tpu_torch.runtime import receding_horizon as rh

        safety = examples.get(args.safety_example)(
            num_time_steps=args.num_time_steps
        )
        t0 = time.perf_counter()
        xs, ts, flags, state = rh.simulate_minimally_invasive(
            problem, safety, params, final_time=args.final_time,
            replan_interval=args.replan_interval,
            planner_time=args.planner_runtime, device=dev,
        )
        _sync(dev)
        main.last_run = {"simulation": (xs, ts, flags, state)}
        n_safety = int(flags.sum())
        print(f"Simulated {float(ts[-1]):.2f} s "
              f"({int(state.num_replans)} replans, safety controller active "
              f"{n_safety}x) in {time.perf_counter() - t0:.2f} s wall.")
        return 0

    if args.receding_horizon:
        from ilqgames_tpu_torch.runtime import receding_horizon as rh

        t0 = time.perf_counter()
        xs, ts, state = rh.simulate(
            problem, params, final_time=args.final_time,
            replan_interval=args.replan_interval,
            planner_time=args.planner_runtime, device=dev,
        )
        _sync(dev)
        main.last_run = {"simulation": (xs, ts, state)}
        print(f"Simulated {float(ts[-1]):.2f} s of sim time "
              f"({int(state.num_replans)} replans) in "
              f"{time.perf_counter() - t0:.2f} s wall.")
        print("Final state:", xs[-1].cpu().numpy())
        return 0

    t0 = time.perf_counter()
    res = problem.solve(params, device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    main.last_run = {"result": res}
    print(f"Solver completed in {dt:.3f} seconds "
          f"(converged={bool(res.converged)}, "
          f"iterations={int(res.cumulative_iterations)}, "
          f"max constraint violation={float(res.max_violation):.4f}).")
    print("Total costs:", res.total_costs.cpu().numpy())

    if args.check_nash:
        from ilqgames_tpu_torch.utils.check_nash import \
            numerical_check_local_nash

        is_nash = numerical_check_local_nash(
            problem.dynamics, problem.player_costs, problem.spec,
            res.strategy, res.op, problem.x0.to(dev),
        )
        print("Solution is" + ("" if is_nash else " NOT")
              + " a numerical local Nash.")

    if args.save or args.viz or args.html:
        log_res, log = problem.solve_logged(params, device=dev)
        main.last_run.update(log_result=log_res, log=log)
        if args.html:
            from ilqgames_tpu_torch import viz_html

            out = viz_html.render_html(problem, log, args.html)
            print(f"Saved HTML animation to {out}")
        if args.save:
            path = log.save(args.experiment_name)
            print(f"Saved log to {path}")
        if args.viz:
            try:
                import matplotlib
            except ImportError as e:
                raise ImportError(
                    "--viz needs matplotlib, which is not installed") from e

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            from ilqgames_tpu_torch import viz

            viz.plot_top_down(problem, log)
            out = f"{args.experiment_name or args.example}.png"
            plt.savefig(out, dpi=120)
            print(f"Saved plot to {out}")
    return 0


main.last_run = {}


if __name__ == "__main__":
    sys.exit(main())
