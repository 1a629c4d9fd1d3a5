"""The port imports without JAX, and on CPU tensors its kernel wrappers
take their plain versions without launching (or building) anything."""
import torch_cpu  # noqa: F401  (one torch thread a test process)
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aslr_to_tpu_torch import two_dof_vsa_boxddp
from aslr_to_tpu_torch.kernels import build, riccati, vsa_kernels

T, B = 3, 2
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_import_leaves_jax_out():
    """Importing every module of the port, and chip_smoke.py, loads no JAX
    and nothing of the JAX package."""
    code = ("import importlib, pkgutil, sys, aslr_to_tpu_torch, chip_smoke; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "aslr_to_tpu_torch.__path__, 'aslr_to_tpu_torch.')]; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('aslr_to_tpu.') or m == 'aslr_to_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_no_jax_import():
    """No import statement of the port or of chip_smoke.py, at module level
    or inside a function, names JAX or the JAX package."""
    files = sorted((ROOT / "aslr_to_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "aslr_to_tpu"), f"{f}: imports {name}"


def test_cpu_wrappers_take_plain_versions_without_launching():
    w = two_dof_vsa_boxddp(T=T, device="cpu")
    spec = vsa_kernels.extract_vsa_spec(w.problem, w.bounds)
    rng = np.random.default_rng(0)
    xs = torch.tensor(0.1 * rng.standard_normal((T + 1, 8, B)))
    us = torch.tensor(np.abs(rng.standard_normal((T, 4, B))))
    wterm = torch.full((B,), spec.w_goal_term, dtype=torch.float64)
    lb = torch.tensor(spec.lb)[:, None].expand(4, B).contiguous()
    ub = torch.tensor(spec.ub)[:, None].expand(4, B).contiguous()
    reg = torch.full((B,), 1e-6, dtype=torch.float64)
    ones = torch.ones(B, dtype=torch.float64)

    build.reset_launches()
    lin = vsa_kernels.linearize(spec, xs, us, wterm)
    r = lin.run
    bw = riccati.riccati_box_backward(r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"],
                                      r["Luu"], lin.term["Lx"], lin.term["Lxx"], us, None,
                                      lb, ub, reg, 2)
    trials = vsa_kernels.rollout2(spec, xs, us, bw.k, bw.K, xs[0], ones, 0.5 * ones,
                                  wterm, lb, ub)
    trial1 = vsa_kernels.rollout1(spec, xs, us, bw.k, bw.K, xs[0], ones, wterm, lb, ub)
    derivs = (r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"], r["Luu"],
              lin.term["Lx"], lin.term["Lxx"])
    fs = torch.zeros((T + 1, 8, B), dtype=torch.float64)
    fddp = riccati.riccati_fddp_backward(*derivs, fs, reg)
    boxfddp = riccati.riccati_boxfddp_backward(*derivs, fs, us, None, lb, ub, reg, 2)
    assert set(build.LAUNCHES) == {"linearize", "riccati_box", "rollout2", "riccati_fddp",
                                   "riccati_boxfddp", "rollout1", "probe"}
    assert set(build.LAUNCHES.values()) == {0}
    assert build._lib is None                      # nothing was built or loaded

    # each wrapper returned exactly what its plain version computes
    plain = vsa_kernels.linearize_plain(spec, xs, us, wterm)
    assert torch.equal(lin.cost, plain.cost) and torch.equal(lin.run["Fx"], plain.run["Fx"])
    bw_p = riccati.riccati_box_plain(r["Fx"], r["Fu"], r["Lx"], r["Lu"], r["Lxx"], r["Lxu"],
                                     r["Luu"], lin.term["Lx"], lin.term["Lxx"], us, None,
                                     lb, ub, reg, 2)
    assert torch.equal(bw.K, bw_p.K) and torch.equal(bw.ok, bw_p.ok)
    roll_p = vsa_kernels.rollout2_plain(spec, xs, us, bw.k, bw.K, xs[0], ones, 0.5 * ones,
                                        wterm, lb, ub)
    for got, want in zip(trials, roll_p):
        assert torch.equal(got.xs, want.xs) and torch.equal(got.cost, want.cost)
    want1 = vsa_kernels.rollout1_plain(spec, xs, us, bw.k, bw.K, xs[0], ones, wterm, lb, ub)
    assert torch.equal(trial1.xs, want1.xs) and torch.equal(trial1.cost, want1.cost)
    assert torch.equal(fddp.K, riccati.riccati_fddp_plain(*derivs, fs, reg).K)
    assert torch.equal(boxfddp.K, riccati.riccati_boxfddp_plain(*derivs, fs, us, None, lb, ub,
                                                                reg, 2).K)


@pytest.mark.parametrize("on_meta", ["x0s", "xs_init", "us_init", "warm_x0s"])
def test_solve_refuses_inputs_off_the_problems_device(on_meta):
    """A solve never moves its inputs: a tensor on another device than the
    problem's raises before any work, for the lane solve and the warm start."""
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver

    w = two_dof_vsa_boxddp(T=T, device="cpu")
    solve = make_batched_solver(w.problem, SolverSettings(maxiter=2), use_gaps=False,
                                bounds=w.bounds, warm_start=on_meta == "warm_x0s",
                                use_fast_path="lanes")
    args = dict(x0s=torch.zeros(B, 8, dtype=torch.float64),
                xs_init=torch.zeros(B, T + 1, 8, dtype=torch.float64),
                us_init=torch.zeros(B, T, 4, dtype=torch.float64))
    if on_meta == "warm_x0s":
        args = dict(x0s=args["x0s"])
    key = "x0s" if on_meta == "warm_x0s" else on_meta
    args[key] = args[key].to("meta")
    build.reset_launches()
    with pytest.raises(ValueError, match=f"{key} is on meta, the problem on cpu"):
        solve(*args.values())
    assert set(build.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("route", [False, True])
def test_generic_and_fast_routes_refuse_x0s_off_the_problems_device(route):
    from aslr_to_tpu_torch import SolverSettings, make_batched_solver

    w = two_dof_vsa_boxddp(T=T, device="cpu")
    solve = make_batched_solver(w.problem, SolverSettings(maxiter=2), use_gaps=False,
                                bounds=w.bounds, use_fast_path=route)
    build.reset_launches()
    with pytest.raises(ValueError, match="x0s is on meta, the problem on cpu"):
        solve(torch.zeros(B, 8, dtype=torch.float64, device="meta"))
    assert set(build.LAUNCHES.values()) == {0}


def test_wrapper_refuses_a_device_it_has_no_route_for():
    w = two_dof_vsa_boxddp(T=T, device="cpu")
    spec = vsa_kernels.extract_vsa_spec(w.problem, w.bounds)
    xs = torch.zeros((T + 1, 8, B), dtype=torch.float64, device="meta")
    us = torch.zeros((T, 4, B), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain route"):
        vsa_kernels.linearize(spec, xs, us, torch.zeros(B, dtype=torch.float64, device="meta"))
