"""Attribute the narrow form of the direct conv's time on a CUDA GPU: what bounds it.

    python tools/conv3d_narrow_variants.py [--reps N]

Builds variants of ``unet3d_tpu_torch/ops/kernels/conv3d_narrow.cu`` by text
substitution into ``build/conv3d_narrow_variants/`` (one nvcc each, started
together): ``base`` (the source as it is), ``no_staging`` (the brick is not
staged: the products read whatever shared memory holds), ``no_products``
(no mma: the staging, the A and B loads and the epilogue alone) and
``no_stores`` (y is not written: everything else runs). Each variant's
kernel is called through its own library with ``conv3d_kernel.narrow_plan``'s
tiling and ``pack_narrow``'s weight at the narrow sites the smoke times
(``chip_smoke.FAMILY_CONV_SHAPES``, ``BN_CONV_SHAPES`` and
``LAST_CONV_SHAPES`` rows in the narrow form), as ``conv`` and as
``block_stats``, on seeded N(0, 1) bf16 inputs, and timed by
``chip_smoke.device_ms``; ``base``'s error against the plain version is
printed beside its time. The variants other than ``base`` compute wrong
values by design. Prints the card and one JSON line. Needs a CUDA GPU and
nvcc.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "build", "conv3d_narrow_variants")

VARIANTS = {
    "base": [],
    "no_staging": [("    stage(0, a.cs);\n", ""),
                   ("      stage(chunk * a.kh * Form<T>::KD, a.kh * Form<T>::KD);\n", "")],
    "no_products": [("for (int mt = 0; mt < MW; ++mt) mma16816(",
                     "for (int mt = 0; mt < MW; ++mt) if (a.n < 0) mma16816(")],
    "no_stores": [("const bool store = kStaged || ok;",
                   "const bool store = kStaged || (ok && a.n < 0);"),
                  ("if (kStaged) {\n    constexpr int VEC", "if (kStaged && a.n < 0) {\n    constexpr int VEC")],
}


def build_variants():
    from unet3d_tpu_torch.kernels import build
    source = open(os.path.join(build._KERNELS, "conv3d_narrow.cu")).read()
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
        cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(build._KERNELS), "-shared",
               "-o", os.path.join(OUT, f"lib{name}.so"), cu]
        procs[name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (cmd, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{' '.join(cmd)}\n{output}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.unet3d_conv3x3x3_narrow.argtypes = [i, p, p, p, p, p, p] + [i] * 18 + [
            ctypes.c_float, p]
        lib.unet3d_conv3x3x3_narrow.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("conv3d_narrow_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unet3d_tpu_torch.ops import conv3d_kernel as K

    libs = build_variants()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    sites = [row for rows in (chip_smoke.FAMILY_CONV_SHAPES, chip_smoke.BN_CONV_SHAPES,
                              chip_smoke.LAST_CONV_SHAPES)
             for row in rows if row[5] == "narrow"]
    result = {name: {} for name in libs}
    errors = {}
    for label, s, cin, cout, dtype, _ in sites:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).to(dtype)
        w = (torch.randn(3, 3, 3, cin, cout, device=device, generator=gen)
             / (27 * cin) ** 0.5).to(dtype)
        inv = torch.rand(1, cin, device=device, generator=gen) + 0.5
        shift = torch.randn(1, cin, device=device, generator=gen) * 0.3
        plan = K.narrow_plan((s, s, s), cin, cout)
        wp = K.pack_narrow(w, plan)
        y = torch.empty(1, s, s, s, cout, dtype=dtype, device=device)
        stats = torch.zeros(1, 2, cout, device=device)
        for name, lib in libs.items():
            times = {}
            for variant in ("conv", "block_stats"):
                code = {"conv": 0, "block_stats": 2}[variant]

                def call():
                    err = lib.unet3d_conv3x3x3_narrow(
                        code, x.data_ptr(), wp.data_ptr(), y.data_ptr(), inv.data_ptr(),
                        shift.data_ptr(), stats.data_ptr(), 1, s, s, s, cin, cout, s, 1,
                        int(plan.fold), plan.cs, plan.kh, plan.chunks, plan.ksteps, plan.nt,
                        plan.n_blocks, *plan.bricks, 0.01, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name} {label}: launch failed ({err})")
                call()
                torch.cuda.synchronize()
                if name == "base" and variant == "conv":
                    errors[label] = chip_smoke.rel_max(y, K.conv3d_reference(x, w))
                times[variant] = chip_smoke.device_ms(call, reps=args.reps)
            result[name][label] = times
            print(f"{name:12s} {label:40s} conv {times['conv']:.4f} ms, block_stats "
                  f"{times['block_stats']:.4f} ms", flush=True)
        del x, w, y, wp
    card = chip_smoke.card_line()
    print(card)
    print(json.dumps({"card": card, "ms": result, "base_rel_err": errors}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
