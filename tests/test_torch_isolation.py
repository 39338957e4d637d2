"""The port stands alone: importing it loads no JAX, and no source of the
port or of chip_smoke.py imports the JAX package."""

import os
import pkgutil
import re
import subprocess
import sys

import locate_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PACKAGE = re.compile(r"\blocate_tpu\b(?!_torch)")


def port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        locate_tpu_torch.__path__, prefix="locate_tpu_torch."))


def test_import_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for name in {['locate_tpu_torch'] + port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'locate_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "locate_tpu_torch")):
        files += [os.path.join(root, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    return files


def test_no_source_imports_the_jax_package():
    assert len(sources()) > 10
    offenders = []
    for path in sources():
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                code = line.split("#", 1)[0]
                importing = (re.match(r"\s*(from|import)\s", code)
                             or "import_module(" in code or "__import__(" in code)
                if importing and (JAX_PACKAGE.search(code) or re.search(r"\bjax\b", code)):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert not offenders, offenders
