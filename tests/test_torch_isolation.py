"""The port stands alone: importing it loads no JAX, and no source of the
port or of chip_smoke.py imports the JAX package. The package's exports
load lazily, and the kernel modules register their ops alone."""

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
    assert {"locate_tpu_torch.ops.flash_attention", "locate_tpu_torch.ops.self_attention",
            "locate_tpu_torch.data.pipeline", "locate_tpu_torch.data.native",
            "locate_tpu_torch.train.loop", "locate_tpu_torch.io.checkpoint",
            "locate_tpu_torch.utils.runlock", "locate_tpu_torch.utils.digest",
            "locate_tpu_torch.utils.metrics",
            "locate_tpu_torch.utils.profiling", "locate_tpu_torch.utils.jax_random",
            "locate_tpu_torch.ops.spectral", "locate_tpu_torch.models.style_generator",
            "locate_tpu_torch.io.projection", "locate_tpu_torch.io.fid",
            "locate_tpu_torch.io.inception", "locate_tpu_torch.io.swd",
            "locate_tpu_torch.parallel.distributed", "locate_tpu_torch.parallel.mesh",
            "locate_tpu_torch.parallel.sharding",
            "locate_tpu_torch.parallel.dryrun"} <= set(port_modules())
    code = (
        "import importlib, sys\n"
        f"for name in {['locate_tpu_torch'] + port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                                    'locate_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_the_package_is_lazy_and_the_ops_register_alone():
    """`import locate_tpu_torch` loads no submodule; the three kernel
    modules register the fourteen `torch.ops.locate.*` ops without the
    model, block or train code; the lazy exports still resolve; and no
    JAX and no JAX package is imported on the way."""
    code = (
        "import sys, torch\n"
        "import locate_tpu_torch\n"
        "port = lambda: sorted(m for m in sys.modules if m.startswith('locate_tpu_torch'))\n"
        "assert port() == ['locate_tpu_torch'], port()\n"
        "from locate_tpu_torch.ops import flash_attention, fused_attention, fused_stage\n"
        "ops = ['flash_fwd', 'flash_dq', 'flash_dkv', 'softmax_gate_stats',\n"
        "       'softmax_gate_apply', 'softmax_gate_csum', 'softmax_gate_backward',\n"
        "       'sigmoid_gate', 'sigmoid_gate_backward', 'stage_conv', 'stage_sigmoid',\n"
        "       'stage_softmax_stats', 'stage_softmax_apply_pool', 'stage_conv_bwd']\n"
        "for name in ops:\n"
        "    assert getattr(torch.ops.locate, name).default.namespace == 'locate'\n"
        "model = [m for m in port() if m.split('.')[1:2] in (['models'], ['nn'], ['train'])]\n"
        "assert not model, model\n"
        "from locate_tpu_torch import Config, get_config, train\n"
        "assert callable(train) and get_config('cifar10_32').model.resolution == 32\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                                    'locate_tpu'))\n"
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
                  if n.endswith((".py", ".cu", ".cuh", ".cc"))]
    return files


def test_no_source_imports_the_jax_package():
    assert len(sources()) > 10
    names = {os.path.relpath(path, REPO) for path in sources()}
    assert {"locate_tpu_torch/ops/flash_attention.py", "locate_tpu_torch/ops/self_attention.py",
            "locate_tpu_torch/csrc/flash_attention.cu",
            "locate_tpu_torch/data/_native/loader.cc", "locate_tpu_torch/io/fid.py",
            "locate_tpu_torch/io/inception.py", "locate_tpu_torch/io/swd.py",
            "locate_tpu_torch/parallel/distributed.py", "locate_tpu_torch/parallel/mesh.py",
            "locate_tpu_torch/parallel/sharding.py", "locate_tpu_torch/parallel/dryrun.py"} <= names
    offenders = []
    for path in sources():
        with open(path) as fh:
            for i, line in enumerate(fh, 1):
                code = line.split("#", 1)[0]
                importing = (re.match(r"\s*(from|import)\s", code)
                             or "import_module(" in code or "__import__(" in code)
                if importing and (JAX_PACKAGE.search(code) or re.search(r"\b(jax|orbax)\b", code)):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{i}: {line.strip()}")
    assert not offenders, offenders


def test_every_kernel_library_has_its_source():
    """The three libraries `ops/cuda/build.py` builds, each from one `.cu` of
    the package and the shared header, under a name its digest decides."""
    from locate_tpu_torch.ops.cuda import build

    paths = {name: build.library_path(name)
             for name in ("fused_attention", "fused_stage", "flash_attention")}
    assert len(set(paths.values())) == 3
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert [p.name for p in build._sources(name)] == [f"{name}.cu", "common.cuh"]
