"""The port stands alone: it imports no JAX, builds nothing on import, and its
GPU entry points refuse to run without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "unet3d_tpu_torch")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import unet3d_tpu_torch
names = [m.name for m in pkgutil.walk_packages(unet3d_tpu_torch.__path__, "unet3d_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from unet3d_tpu_torch.kernels import build
assert build._lib is None, "importing the package built or loaded the kernels"
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "unet3d_tpu", "triton"))
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""

# the training slice's modules, which must stand alone like the rest
TRAINING_MODULES = ("ops.s2_wgrad_kernel", "ops.interpolate", "train.losses",
                    "train.optim", "train.step", "train.meters", "train.train",
                    "train.checkpoint")
# the prediction CLI's slice: the data path, the CLIs and the Winograd kernel
PREDICT_CLI_MODULES = ("ops.winograd_kernel", "ops.affine", "ops.one_hot", "ops.crop",
                       "ops.normalize", "ops.resample", "data.orientation", "data.io",
                       "data.dataset", "data.loader", "scripts.predict",
                       "scripts.segment")
# the train CLI's slice: the random stages, the prefetcher and the CLI
TRAIN_CLI_MODULES = ("data.transforms", "data.prefetch", "config.factory", "scripts.train")


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def test_every_module_imports_without_jax_or_a_build():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = sum(f.endswith(".py") and f != "__init__.py"
                    for _, _, files in os.walk(PACKAGE) for f in files)
    *_, names, count = out.stdout.strip().splitlines()
    assert int(count) >= n_modules
    assert {f"unet3d_tpu_torch.{m}" for m in TRAINING_MODULES} <= set(names.split())
    assert {f"unet3d_tpu_torch.{m}" for m in PREDICT_CLI_MODULES} <= set(names.split())
    assert {f"unet3d_tpu_torch.{m}" for m in TRAIN_CLI_MODULES} <= set(names.split())


def test_no_source_of_the_port_names_jax():
    for dirpath, _, files in os.walk(PACKAGE):
        for f in files:
            if f.endswith((".py", ".cu")):
                text = open(os.path.join(dirpath, f)).read()
                for line in text.splitlines():
                    stripped = line.strip()
                    assert not stripped.startswith(("import jax", "from jax",
                                                    "import flax", "from flax",
                                                    "from unet3d_tpu.",
                                                    "import unet3d_tpu")), (f, line)


def test_kernel_wrapper_raises_for_a_device_without_a_kernel():
    from unet3d_tpu_torch.ops import conv3d_kernel as kernels
    from unet3d_tpu_torch.ops import s2_wgrad_kernel
    x = torch.empty(1, 2, 2, 2, 3, device="meta")
    w = torch.empty(3, 3, 3, 3, 4, device="meta")
    before = dict(kernels.LAUNCHES), dict(s2_wgrad_kernel.LAUNCHES)
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.conv3x3x3(x, w)
    with pytest.raises(RuntimeError, match="no kernel"):
        s2_wgrad_kernel.s2_wgrad(x, torch.empty(1, 1, 1, 1, 4, device="meta"))
    assert (kernels.LAUNCHES, s2_wgrad_kernel.LAUNCHES) == before


def test_require_cuda_matches_the_machine():
    from unet3d_tpu_torch.utils.device import require_cuda
    if torch.cuda.is_available():
        assert require_cuda().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            require_cuda()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_gpu_or_the_repo(alone, tmp_path):
    if torch.cuda.is_available() and not alone:
        pytest.skip("a GPU is present: chip_smoke.py would run the whole path")
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.cuda
def test_kernels_build_and_load_on_a_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels are built with nvcc for sm_90a)")
    from unet3d_tpu_torch.kernels.build import library_path, load_library
    load_library()
    assert library_path().exists()
