"""The check that nothing the harness runs loads JAX or the JAX package."""

import os
import subprocess
import sys

from portbench.harness import imports
from portbench.harness.registry import REPO


def test_top_level_names_compared_whole():
    names = ["dcol_tpu_torch", "dcol_tpu_torch.ops.pdip", "numpy", "jaxlib.xla",
             "dcol_tpu", "dcol_tpu.solver", "flax", "jax_like", "jaxtyping"]
    assert imports.forbidden_loaded(names) == [
        "dcol_tpu", "dcol_tpu.solver", "flax", "jaxlib.xla"]


def test_harness_and_port_load_nothing_forbidden():
    """In a fresh interpreter: the harness, the port's entry points and a
    plain reference, then the check."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.harness import cells, check, runner, trace, imports\n"
        "from portbench.harness.registry import Registry\n"
        "import dcol_tpu_torch.solver.altro, dcol_tpu_torch.solver.mpc\n"
        "import dcol_tpu_torch.systems.quadrotor, dcol_tpu_torch.systems.piano_mover\n"
        "r = Registry(); r.reference('quad_hallway')\n"
        "print(','.join(imports.forbidden_loaded()))\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_no_harness_file_reads_the_reference_package():
    root = os.path.join(REPO, "portbench")
    for dirpath, _, files in os.walk(root):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                for bad in ("import jax", "from jax", "import dcol_tpu\n",
                            "from dcol_tpu import", "from dcol_tpu."):
                    assert bad not in src, (f, bad)
                assert not any("benchmarks" in ln and ("open(" in ln
                                                       or "path" in ln)
                               for ln in src.splitlines()), f
