"""The port stands alone: importing every module of ilqgames_tpu_torch
pulls in no JAX, no flax and nothing of the JAX package."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

_SCRIPT = """
import importlib, pkgutil, sys
import ilqgames_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    ilqgames_tpu_torch.__path__, "ilqgames_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "ilqgames_tpu"))
runtime = sorted(n for n in names if n.startswith("ilqgames_tpu_torch.runtime."))
print(len(names), ",".join(runtime), bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    n, runtime, bad = out.stdout.strip().split(" ", 2)
    assert bad == "[]", bad
    # Every module of the port, down to the kernel wrappers, and the
    # receding-horizon runtime among them.
    assert int(n) >= 20, n
    assert runtime == "ilqgames_tpu_torch.runtime.receding_horizon", runtime


def test_chip_smoke_refuses_without_cuda():
    """chip_smoke.py exits nonzero and prints no result line when no CUDA
    device is visible (this machine's CPU build of torch has none)."""
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_kernel_wrappers_share_one_stream_helper():
    """Every kernel wrapper passes its C function the current stream's raw
    handle from `build.stream`; none builds a Stream object at launch."""
    cuda = REPO / "ilqgames_tpu_torch" / "ops" / "cuda"
    for name in ("lq", "sweep", "stage", "probes", "lq_open_loop"):
        src = (cuda / f"{name}.py").read_text()
        assert "current_stream" not in src, name
        assert "build.stream(dev)" in src, name


def test_unconstrained_games_import_no_jax():
    """The two unconstrained games, the linear dynamics, the new atoms and
    the bench's configs are among the port's modules and pull in no JAX."""
    script = (
        "import sys\n"
        "from ilqgames_tpu_torch.examples import two_player_collision, "
        "two_player_point_mass\n"
        "from ilqgames_tpu_torch.costs.atoms import final_time, proximity, "
        "semiquadratic_polyline2\n"
        "from ilqgames_tpu_torch.dynamics.base import linear\n"
        "from ilqgames_tpu_torch import bench\n"
        "assert sorted(map(str, bench.CONFIGS)) == "
        "['1', '2', '4', '5', 'air3d', 'collision_reach', 'dubins_fb', "
        "'dubins_ol', 'flat_roundabout', 'roundabout']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ilqgames_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_flat_game_imports_no_jax():
    """The flat dynamics, the norm atoms, the flat intersection and its
    bench config pull in no JAX."""
    script = (
        "import sys\n"
        "from ilqgames_tpu_torch.dynamics import flat\n"
        "from ilqgames_tpu_torch.costs.atoms import quadratic_norm, "
        "semiquadratic_norm\n"
        "from ilqgames_tpu_torch.examples import "
        "three_player_flat_intersection\n"
        "from ilqgames_tpu_torch import bench\n"
        "assert bench.CONFIGS[4]['make'] is "
        "three_player_flat_intersection.make_problem\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ilqgames_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reachability_game_imports_no_jax():
    """car_5d, the signed-distance and extreme-value atoms, the
    single-dimension constraint, the reachability example and its bench
    config pull in no JAX."""
    script = (
        "import sys\n"
        "from ilqgames_tpu_torch.dynamics.models import car_5d\n"
        "from ilqgames_tpu_torch.costs.atoms import extreme_value, "
        "signed_distance\n"
        "from ilqgames_tpu_torch.costs.constraints import single_dimension\n"
        "from ilqgames_tpu_torch.examples import reachability\n"
        "from ilqgames_tpu_torch.runtime import receding_horizon\n"
        "from ilqgames_tpu_torch import bench\n"
        "assert bench.CONFIGS[5]['make'] is reachability.make_problem\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ilqgames_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_open_loop_pieces_import_no_jax():
    """dubins_car, quadratic_difference, dubins_origin, the open-loop LQ
    solve and its kernel's wrapper, the Nash oracles and the dubins bench
    configs pull in no JAX."""
    script = (
        "import sys\n"
        "from ilqgames_tpu_torch.dynamics.models import dubins_car\n"
        "from ilqgames_tpu_torch.costs.atoms import quadratic_difference\n"
        "from ilqgames_tpu_torch.examples import dubins_origin\n"
        "from ilqgames_tpu_torch.solver.lq_open_loop import "
        "solve_lq_open_loop\n"
        "from ilqgames_tpu_torch.ops.cuda import lq_open_loop\n"
        "from ilqgames_tpu_torch.utils.check_nash import "
        "numerical_check_local_nash\n"
        "from ilqgames_tpu_torch import bench\n"
        "assert bench.CONFIGS['dubins_ol']['make'] is "
        "dubins_origin.make_problem\n"
        "assert bench.KERNELS['K7'] is lq_open_loop.lq_open_loop\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ilqgames_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_driving_games_import_no_jax():
    """The semiquadratic atom, the routes, the five driving examples, the
    registry (every ported builder) and the roundabout's bench config
    pull in no JAX."""
    script = (
        "import sys\n"
        "from ilqgames_tpu_torch.costs.atoms import semiquadratic\n"
        "from ilqgames_tpu_torch.examples import routes, roundabout_merging\n"
        "import ilqgames_tpu_torch.examples as ex\n"
        "probs = [ex.get(n)() for n in ex.ported()]\n"
        "from ilqgames_tpu_torch import bench\n"
        "assert bench.CONFIGS['roundabout']['make'] is "
        "roundabout_merging.make_problem\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ilqgames_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_reach_family_imports_no_jax():
    """point_mass_2d, the polyline signed-distance atom, the circle and
    the square, the three reachability examples of this family through
    the registry, their bench config and golden run pull in no JAX."""
    script = (
        "import sys\n"
        "from ilqgames_tpu_torch.dynamics.models import point_mass_2d\n"
        "from ilqgames_tpu_torch.costs.atoms import "
        "polyline2_signed_distance\n"
        "from ilqgames_tpu_torch.geometry import draw_circle, draw_square\n"
        "from ilqgames_tpu_torch.examples import more_reachability\n"
        "import ilqgames_tpu_torch.examples as ex\n"
        "for n in ('one_player_reachability', 'modified_air_3d', "
        "'two_player_collision_avoidance_reachability'):\n"
        "    ex.get(n)()\n"
        "from ilqgames_tpu_torch import bench\n"
        "assert bench.CONFIGS['collision_reach']['make'] is "
        "more_reachability.make_two_player_collision_avoidance\n"
        "assert bench.GOLDEN_RUNS['one_player_reach'][0]().name == "
        "'one_player_reachability'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ilqgames_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_coupled_reach_imports_no_jax():
    """The coupled systems two_player_unicycle_4d and air_3d, the examples
    air_3d and two_player_reachability through the registry, the air3d
    bench config and the two-player golden run pull in no JAX."""
    script = (
        "import sys\n"
        "from ilqgames_tpu_torch.dynamics.models import air_3d, "
        "two_player_unicycle_4d\n"
        "air_3d(1.0, 1.0), two_player_unicycle_4d()\n"
        "from ilqgames_tpu_torch.examples import air_3d as air\n"
        "import ilqgames_tpu_torch.examples as ex\n"
        "for n in ('air_3d', 'two_player_reachability'):\n"
        "    ex.get(n)()\n"
        "from ilqgames_tpu_torch import bench\n"
        "assert bench.CONFIGS['air3d']['make'] is air.make_problem\n"
        "assert bench.GOLDEN_RUNS['two_player_reach'][0]().name == "
        "'two_player_reachability'\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ilqgames_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_flat_driving_games_import_no_jax():
    """The route-progress atom, the flat models' real-coordinate maps, the
    two flat driving games through the registry, the flat roundabout's
    bench config and the flat overtaking's nominal run pull in no JAX."""
    script = (
        "import sys\n"
        "from ilqgames_tpu_torch.costs.atoms import route_progress\n"
        "from ilqgames_tpu_torch.dynamics.flat import "
        "linear_controls_to_real\n"
        "from ilqgames_tpu_torch.examples import flat_roundabout_merging, "
        "three_player_flat_overtaking\n"
        "import ilqgames_tpu_torch.examples as ex\n"
        "assert len(ex.ported()) == 18\n"
        "for n in ('three_player_flat_overtaking', "
        "'flat_roundabout_merging'):\n"
        "    ex.get(n)().initial_operating_point()\n"
        "from ilqgames_tpu_torch import bench\n"
        "assert bench.CONFIGS['flat_roundabout']['make'] is "
        "flat_roundabout_merging.make_problem\n"
        "assert bench.GOLDEN_RUNS['flat_overtaking'][0] is "
        "three_player_flat_overtaking.make_problem\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ilqgames_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cost_zoo_imports_no_jax():
    """The rest of the cost layer (the six atoms, the four constraints)
    and chip_smoke.py's two zoo games, their tables and kernel libraries
    pull in no JAX."""
    script = (
        "import sys\n"
        "from ilqgames_tpu_torch.costs.atoms import relative_distance, "
        "nominal_path_length, curvature, orientation, "
        "locally_convex_proximity, weighted_convex_proximity\n"
        "from ilqgames_tpu_torch.costs.constraints import affine_scalar, "
        "affine_vector, polyline2_signed_distance, final_time\n"
        "import chip_smoke\n"
        "from ilqgames_tpu_torch import bench\n"
        "from ilqgames_tpu_torch.ops.cuda import cost_table\n"
        "for fused in (True, False):\n"
        "    g = chip_smoke.zoo_problem(fused, 11)\n"
        "    bench.kernel_libraries(g.dynamics, g.spec, g.player_costs)\n"
        "    assert cost_table.has_table(g.player_costs, g.spec) == fused\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'ilqgames_tpu'))\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
