"""Attribute the stride-2 weight gradient's time on a CUDA GPU: what bounds it.

    python tools/s2_wgrad_variants.py [--reps N]

Builds variants of ``unet3d_tpu_torch/ops/kernels/s2_wgrad_wgmma.cu`` by text
substitution into ``build/s2_wgrad_variants/`` (one nvcc each, started
together, each linked with ``s2_wgrad.cu`` for its split-K sum): ``base``
(the source as it is), ``no_products`` (no wgmma: the staging loads and
barriers alone), ``no_loads`` (no staging after the first
segments: the products and barriers alone), ``no_x_loads`` and
``no_g_loads`` (one operand's staging left out). Each variant's kernel is
called through its own library with ``s2_wgrad_kernel.wgmma_plan``'s tiling
at every ``chip_smoke.S2_SHAPES`` site, on seeded N(0, 1) bf16 inputs, and
timed by ``chip_smoke.device_ms``. ``base`` is also run with its splits of K
forced to 1 (every block sums all its voxels in one accumulator): its time
and its error against the f32 reference (TF32 off) beside the plan's. The
variants other than ``base`` compute wrong values by design. Prints the card
and one JSON line. Needs a CUDA GPU and nvcc.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "build", "s2_wgrad_variants")

PRODUCTS = "    for (int ks = 0; ks < KSTEPS; ++ks)\n      Wgmma<BN, 1>::mma("
LOADS = "if (s + LEAD < steps) load_segment("
X_LOADS = "      if (xli[p] < 0) continue;  // past the staged rows: never read"
G_LOADS = "    for (int p = 0; p < Cfg::G_PASSES; ++p) {"
VARIANTS = {
    "base": [],
    "no_products": [(PRODUCTS, "    if (steps < 0) for (int ks = 0; ks < KSTEPS; ++ks)\n"
                               "      Wgmma<BN, 1>::mma(")],
    "no_loads": [(LOADS, "if (steps < 0) load_segment(")],
    "no_x_loads": [(X_LOADS, "      if (steps > 0) continue;")],
    "no_g_loads": [(G_LOADS, "    for (int p = 0; p < 0; ++p) {")],
}


def build_variants():
    from unet3d_tpu_torch.kernels import build
    source = open(os.path.join(build._KERNELS, "s2_wgrad_wgmma.cu")).read()
    os.makedirs(OUT, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for name, subs in VARIANTS.items():
        text = source
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer holds {old!r}")
            text = text.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        # s2_wgrad.cu holds the split-K sum the variant calls
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(build._KERNELS), "-shared",
               "-o", os.path.join(OUT, f"lib{name}.so"), cu,
               str(build._KERNELS / "s2_wgrad.cu")]
        procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (cmd, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{output}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.unet3d_s2_wgrad_wgmma.argtypes = [i, i, p, p, p, p] + [i] * 16 + [p]
        lib.unet3d_s2_wgrad_wgmma.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("s2_wgrad_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as W

    torch.backends.cudnn.allow_tf32 = False
    libs = build_variants()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    result = {}
    for label, s, cin, cout in chip_smoke.S2_SHAPES:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).bfloat16()
        g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device,
                        generator=gen).bfloat16()
        want = W.s2_wgrad_reference(x, g)
        plan = W.wgmma_plan(tuple(x.shape), cout, sms)
        one_split = plan._replace(splits=1, per_split=plan.segments)
        dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=device)
        part = torch.empty((plan.splits, 27 * cin, cout), dtype=torch.float32, device=device)

        def call(lib, pl):
            def run():
                err = lib.unet3d_s2_wgrad_wgmma(
                    pl.bn, pl.stages, x.data_ptr(), g.data_ptr(), part.data_ptr(),
                    dw.data_ptr(), 1, s, s, s, cin, s // 2, s // 2, s // 2, cout,
                    pl.n_tiles, pl.chunks, pl.sw, pl.segments, pl.splits, pl.per_split,
                    1, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return run

        site = {name: chip_smoke.device_ms(call(lib, plan), args.reps)
                for name, lib in libs.items()}
        for name, pl in (("base", plan), ("base_one_split", one_split)):
            call(libs["base"], pl)()
            torch.cuda.synchronize()
            site[f"{name}_rel_err"] = ((dw - want).abs().max() / want.abs().max()).item()
        site["base_one_split"] = chip_smoke.device_ms(call(libs["base"], one_split), args.reps)
        site["splits"] = plan.splits
        result[label] = site
        print(label, json.dumps(site), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"card": chip_smoke.card_line(), "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
