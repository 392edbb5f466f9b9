"""Attribute the Winograd-DH wgmma kernel's time on a CUDA GPU: what bounds it.

    python tools/winograd_variants.py [--reps N]

Builds variants of ``unet3d_tpu_torch/ops/kernels/winograd_wgmma.cu`` by
text substitution into ``build/winograd_variants/`` (one nvcc each, started
together), each with one part of the per-point work left out: ``base`` (the
source as it is), ``no_products`` (no wgmma: loads, transforms, folds and
barriers alone), ``no_fold`` (no fold of the point products into the output
tiles), ``no_u2_loads`` (no B slab loads after the first points),
``no_window_loads`` (no raw window loads after the first two chunks),
``no_h_transform`` (one ldmatrix and no add per A fragment: half the H
transform's reads) and ``no_barrier`` (no barrier per point). Each
variant's kernel is called through its own library with
``winograd_kernel.wgmma_plan``'s tiling and ``pack_u2``'s weight at every
``chip_smoke.WINO_SHAPES`` site, on seeded N(0, 1) bf16 inputs, and timed by
``chip_smoke.device_ms`` beside cuDNN's ``F.conv3d`` and the bound; ``base``
is also checked against ``winograd_reference`` and timed with the
statistics. The variants other than ``base`` compute wrong values by design.
Prints each variant's registers and spills, the card and one JSON line.
Needs a CUDA GPU and nvcc.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "build", "winograd_variants")

VARIANTS = {
    "base": [],
    "no_products": [("Wgmma<BN>::mma(", "if (c < 0) Wgmma<BN>::mma(")],
    "no_fold": [("if (ch == 0) continue;", "if (ch == 0 || a.n > 0) continue;")],
    "no_u2_loads": [("          load_slab(sb + k);", "          if (c < 0) load_slab(sb + k);")],
    "no_window_loads": [("if (first && c + 1 < a.chunks) load_window(",
                         "if (first && c + 1 < a.chunks && c < 1) load_window(")],
    "no_h_transform": [("        ldmatrix_x4(lb[dx][ks] + rb, v);",
                        "        v[0] = v[1] = v[2] = v[3] = 0;")],
    "no_barrier": [("        __syncthreads();\n        // the slabs point", "        // the slabs point")],
}


def build_variants():
    from unet3d_tpu_torch.kernels import build
    source = open(os.path.join(build._KERNELS, "winograd_wgmma.cu")).read()
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
        cmd = [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-I", str(build._KERNELS),
               "-shared", "-o", os.path.join(OUT, f"lib{name}.so"), cu]
        procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs, notes = {}, {}
    for name, (cmd, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{output}")
        lines = output.splitlines()
        notes[name] = dict(
            registers=[l.split("Used ")[1].split(" registers")[0] for l in lines if "Used " in l],
            spills=sorted({l.strip() for l in lines if "spill" in l}),
            serialized=sorted({l.split("Loss: ")[1].split(" in the function")[0]
                               for l in lines if "Loss: " in l}))
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.unet3d_winograd_wgmma.argtypes = [i, i, p, p, p, p] + [i] * 12 + [p]
        lib.unet3d_winograd_wgmma.restype = i
        libs[name] = lib
    return libs, notes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("winograd_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unet3d_tpu_torch.ops import winograd_kernel as W

    torch.backends.cudnn.allow_tf32 = False
    libs, notes = build_variants()
    for name, note in notes.items():
        print(name, json.dumps(note), flush=True)
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    result = {}
    for label, s, cin, cout in chip_smoke.WINO_SHAPES:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).bfloat16()
        w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
             / (27 * cin) ** 0.5).bfloat16()
        plan = W.wgmma_plan(tuple(x.shape), cout)
        u2 = W.pack_u2(w, plan)
        y = torch.empty(1, s, s, s, cout, device=device, dtype=torch.bfloat16)
        stats = torch.zeros(1, 2, cout, device=device)

        def call(lib, with_stats=0):
            def run():
                err = lib.unet3d_winograd_wgmma(
                    with_stats, plan.config, x.data_ptr(), u2.data_ptr(), y.data_ptr(),
                    stats.data_ptr(), 1, s, 1, 1, s, s, cin, cout, plan.h_tiles, plan.w_tiles,
                    plan.n_tiles, plan.chunks, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return run

        site = {name: chip_smoke.device_ms(call(lib), args.reps) for name, lib in libs.items()}
        site["base_stats"] = chip_smoke.device_ms(call(libs["base"], 1), args.reps)
        call(libs["base"])()
        torch.cuda.synchronize()
        want = W.winograd_reference(x, w).float()
        site["base_rel_err"] = ((y.float() - want).abs().max() / want.abs().max()).item()
        site["cudnn"] = chip_smoke.device_ms(chip_smoke.library_conv(x, w), args.reps)
        site["bound"] = chip_smoke.conv_bound("winograd", s, cin, cout,
                                              chip_smoke.WINOGRAD_PRODUCTS)[0]
        site["plan"] = plan._asdict()
        result[label] = site
        print(label, json.dumps(site), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"card": chip_smoke.card_line(), "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
