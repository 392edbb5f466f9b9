"""Measure the f32 3x3x3 conv's 3xTF32 form on a CUDA GPU: how its partial
sums are folded, against accuracy and time.

    python tools/tf32x3_variants.py [--reps N]

Builds variants of ``unet3d_tpu_torch/ops/kernels/conv3d_tf32x3.cu`` by text
substitution into ``build/tf32x3_variants/`` (one nvcc each, started
together): ``base`` (the source as it is: the tensor cores sum two taps'
products, then an f32 add folds them into the accumulator), ``fold_each_tap``
(the fold after every tap) and ``no_fold`` (the tensor cores sum all of K in
one accumulator, as a plain wgmma GEMM does; the split into hi and lo and the
three products are unchanged). Each variant's ``conv`` is called through its
own library with ``conv3d_kernel.tf32_plan``'s tiling and ``pack_tf32``'s
weight on seeded N(0, 1) f32 inputs, held against ``conv3d_reference`` (f32,
TF32 off; relative to the largest output) at widths from 32 to 384 input
channels, and timed by ``chip_smoke.device_ms`` at SegResNetVAE's three
decoder sites beside ``F.conv3d`` with TF32 off and the 3xTF32 bound.
Prints each variant's registers, spills and any wgmma serialization note,
the card and one JSON line. Needs a CUDA GPU and nvcc.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "build", "tf32x3_variants")

VARIANTS = {
    "base": [],
    "fold_each_tap": [
        ("PARITY == 0 && ks == 0 ? 0 : 1", "ks == 0 ? 0 : 1"),
        ("step(s, First{}, std::false_type{});", "step(s, First{}, std::true_type{});")],
    "no_fold": [
        ("PARITY == 0 && ks == 0 ? 0 : 1", "s == 0 && ks == 0 ? 0 : 1"),
        ("acc[mt][i] += part[mt][i];", "acc[mt][i] = part[mt][i];")],
}
# (spatial, Cin, Cout): the error grows with K = 27 * Cin
ACCURACY_SHAPES = [((1, 32, 32, 32), 32, 32), ((1, 32, 32, 32), 64, 64),
                   ((1, 16, 16, 16), 128, 128), ((1, 16, 16, 16), 192, 96),
                   ((1, 8, 8, 8), 384, 384)]
# SegResNetVAE's decoder sites, f32 under AMP
TIMED_SHAPES = [(128, 32, 32), (64, 64, 64), (32, 128, 128)]


def build_variants():
    from unet3d_tpu_torch.kernels import build
    source = open(os.path.join(build._KERNELS, "conv3d_tf32x3.cu")).read()
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
            spills=sorted({l.strip() for l in lines if "spill" in l and " 0 bytes spill" not in l}),
            serialized=sorted({l.split("Loss: ")[1].split(" in the function")[0]
                               for l in lines if "Loss: " in l}))
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.unet3d_conv3x3x3_tf32x3.argtypes = [i, i, p, p, p, p, p, p] + [i] * 13 + [
            ctypes.c_float, p]
        lib.unet3d_conv3x3x3_tf32x3.restype = i
        libs[name] = lib
    return libs, notes


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tf32x3_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unet3d_tpu_torch.ops import conv3d_kernel as K

    libs, notes = build_variants()
    for name, note in notes.items():
        print(name, json.dumps(note), flush=True)
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)

    def call(lib, x, w, y):
        n, d, h, wd, cin = x.shape
        cout = w.shape[-1]
        plan = K.tf32_plan((d, h, wd), cin, cout)
        wp = K.pack_tf32(w, plan.bn)

        def run():
            err = lib.unet3d_conv3x3x3_tf32x3(
                0, plan.config, x.data_ptr(), wp.data_ptr(), y.data_ptr(), None, None, None,
                n, d, h, wd, cin, cout, d, 1, *plan.bricks, plan.n_tiles, plan.chunks, 0.01,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
        return run

    def inputs(shape, cin, cout):
        x = torch.randn(*shape, cin, device=device, generator=gen)
        w = torch.randn(3, 3, 3, cin, cout, device=device, generator=gen) / (27 * cin) ** 0.5
        return x, w, torch.empty(*shape, cout, device=device)

    result = {"rel_err": {}, "ms": {}}
    for shape, cin, cout in ACCURACY_SHAPES:
        x, w, y = inputs(shape, cin, cout)
        want = K.conv3d_reference(x, w).double()
        site = {}
        for name, lib in libs.items():
            call(lib, x, w, y)()
            torch.cuda.synchronize()
            site[name] = float((y.double() - want).abs().max() / want.abs().max())
        label = f"{cin}->{cout} @{shape[1]}^3"
        result["rel_err"][label] = site
        print(f"rel max err {label}: {json.dumps(site)}", flush=True)
    for s, cin, cout in TIMED_SHAPES:
        x, w, y = inputs((1, s, s, s), cin, cout)
        site = {name: chip_smoke.device_ms(call(lib, x, w, y), args.reps)
                for name, lib in libs.items()}
        site["F.conv3d (TF32 off)"] = chip_smoke.device_ms(chip_smoke.library_conv(x, w),
                                                           args.reps)
        site["3xTF32 bound"] = chip_smoke.tf32x3_bound("conv", s, cin, cout)[0]
        label = f"{cin}->{cout} @{s}^3"
        result["ms"][label] = site
        print(f"ms {label}: {json.dumps(site)}", flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"card": chip_smoke.card_line(), **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
