"""Attribute the time of the two new 3xTF32 forms on a CUDA GPU: what bounds them.

    python tools/tf32x3_narrow_s2_variants.py [--reps N]

Builds variants of ``unet3d_tpu_torch/ops/kernels/s2_wgrad_tf32x3.cu`` (the
f32 stride-2 weight gradient) and of ``conv3d_narrow.cu`` (its f32
``tf32x3_narrow`` instantiation) by text substitution into
``build/tf32x3_narrow_s2_variants/`` (one nvcc each, started together; the
s2_wgrad ones linked with ``s2_wgrad.cu`` for the split-K sum): ``base`` (the
source as it is), ``one_product`` (hi*hi alone: a third of the products),
``no_split`` (no cvt.rna: the raw f32 bits as hi, lo zero), ``no_products``
(no wgmma / mma: the loads, the split's dead code gone, the barriers and
the stores), and, for s2_wgrad, ``no_loads`` (no staging after the first
segment) and ``no_transpose`` (g's split tiles not written), for the conv,
``no_staging`` (the brick is not staged). Each variant's kernel is
called through its own library with the wrapper's plan and packing at the
f32 sites the smoke times (``chip_smoke.S2_SHAPES``; the conv's 3 -> 3 and
3 -> 16 at 128^3), on seeded N(0, 1) inputs, and timed by
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
OUT = os.path.join(REPO, "build", "tf32x3_narrow_s2_variants")

S2_MMA = ("      WgmmaTf32<BN>::mma(alo[p], dhi, part, ks == 0 ? 0 : 1);  // a segment starts "
          "part anew\n      WgmmaTf32<BN>::mma(ahi[p], dlo, part);\n"
          "      WgmmaTf32<BN>::mma(ahi[p], dhi, part);\n")
S2_VARIANTS = {
    "base": [],
    "one_product": [(S2_MMA, "      WgmmaTf32<BN>::mma(ahi[p], dhi, part, ks == 0 ? 0 : 1);\n")],
    "no_split": [
        ("for (int e = 0; e < 4; ++e) tf32_split(v[e], ahi[p][e], alo[p][e]);",
         "for (int e = 0; e < 4; ++e) { ahi[p][e] = __float_as_uint(v[e]); alo[p][e] = 0u; }"),
        ("for (int e = 0; e < 4; ++e) tf32_split(graw[(4 * v4 + e) * GP + co], h[e], l[e]);",
         "for (int e = 0; e < 4; ++e) { h[e] = __float_as_uint(graw[(4 * v4 + e) * GP + co]);"
         " l[e] = 0u; }")],
    "no_products": [(S2_MMA, "      if (steps < 0) {\n" + S2_MMA + "      }\n")],
    "no_loads": [("if (s + LEAD < steps) load_segment(", "if (steps < 0) load_segment(")],
    "no_transpose": [("    split_g(s % STAGES);\n", "")],
}
CONV_MMA = ("          mma_tf32x3_m16n8k8(acc[mt][j], hi[mt], lo[mt], fb[j].x, fb[j].y, fb[j].z, "
            "fb[j].w);")
CONV_VARIANTS = {
    "base": [],
    "one_product": [(CONV_MMA, "          mma_tf32_m16n8k8(acc[mt][j], hi[mt], fb[j].x, fb[j].y);")],
    "no_split": [("tf32_split(__uint_as_float(fa[mt][e]), hi[mt][e], lo[mt][e]);",
                  "{ hi[mt][e] = fa[mt][e]; lo[mt][e] = 0u; }")],
    "no_products": [(CONV_MMA, "          if (a.n < 0) " + CONV_MMA.strip())],
    "no_staging": [("    stage(0, a.cs);\n", ""),
                   ("      stage(chunk * a.kh * Form<T>::KD, a.kh * Form<T>::KD);\n", "")],
}


def build_variants():
    from unet3d_tpu_torch.kernels import build
    os.makedirs(OUT, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for kind, source, variants in (("s2", "s2_wgrad_tf32x3.cu", S2_VARIANTS),
                                   ("conv", "conv3d_narrow.cu", CONV_VARIANTS)):
        text0 = open(os.path.join(build._KERNELS, source)).read()
        for name, subs in variants.items():
            text = text0
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{kind} {name}: the source no longer holds {old!r}")
                text = text.replace(old, new)
            cu = os.path.join(OUT, f"{kind}_{name}.cu")
            with open(cu, "w") as f:
                f.write(text)
            extra = [str(build._KERNELS / "s2_wgrad.cu")] if kind == "s2" else []
            cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(build._KERNELS), "-shared",
                   "-o", os.path.join(OUT, f"lib{kind}_{name}.so"), cu, *extra]
            procs[kind, name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for (kind, name), (cmd, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kind} {name}:\n{' '.join(cmd)}\n{output}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{kind}_{name}.so"))
        if kind == "s2":
            lib.unet3d_s2_wgrad_tf32x3.argtypes = [i, p, p, p, p] + [i] * 16 + [p]
            lib.unet3d_s2_wgrad_tf32x3.restype = i
        else:
            lib.unet3d_conv3x3x3_narrow_tf32x3.argtypes = [i] + [p] * 6 + [i] * 18 + [
                ctypes.c_float, p]
            lib.unet3d_conv3x3x3_narrow_tf32x3.restype = i
        libs[kind, name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("tf32x3_narrow_s2_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unet3d_tpu_torch.ops import conv3d_kernel as K
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as W

    libs = build_variants()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    result = {}
    for label, s, cin, cout in chip_smoke.S2_SHAPES:
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen)
        g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device, generator=gen)
        want = W.s2_wgrad_reference(x, g)
        plan = W.tf32_plan(tuple(x.shape), cout, sms)
        dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=device)
        part = torch.empty((plan.splits, 27 * cin, cout), dtype=torch.float32, device=device)

        def call(lib):
            def run():
                err = lib.unet3d_s2_wgrad_tf32x3(
                    plan.bn, x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), 1, s,
                    s, s, cin, s // 2, s // 2, s // 2, cout, plan.n_tiles, plan.chunks, plan.sw,
                    plan.segments, plan.splits, plan.per_split, 1, stream())
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return run

        site = {name: chip_smoke.device_ms(call(libs["s2", name]), args.reps)
                for name in S2_VARIANTS}
        call(libs["s2", "base"])()
        torch.cuda.synchronize()
        site["base_rel_err"] = ((dw - want).abs().max() / want.abs().max()).item()
        site["plan"] = plan._asdict()
        result[f"s2_wgrad {label}"] = site
        print(f"s2_wgrad {label}", json.dumps(site), flush=True)
    for label, s, cin, cout in (("3->3 @128^3", 128, 3, 3), ("dx 3->16 @128^3", 128, 3, 16)):
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen)
        w = torch.randn(3, 3, 3, cin, cout, device=device, generator=gen) / (27 * cin) ** 0.5
        want = K.conv3d_reference(x, w)
        plan = K.narrow_plan((s, s, s), cin, cout, torch.float32)
        wp = K.pack_narrow(w, plan)
        y = torch.empty(1, s, s, s, cout, device=device)

        def call(lib):
            def run():
                err = lib.unet3d_conv3x3x3_narrow_tf32x3(
                    0, x.data_ptr(), wp.data_ptr(), y.data_ptr(), None, None, None, 1, s, s, s,
                    cin, cout, s, 1, int(plan.fold), plan.cs, plan.kh, plan.chunks,
                    plan.ksteps, plan.nt, plan.n_blocks, *plan.bricks, 0.01, stream())
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return run

        site = {name: chip_smoke.device_ms(call(libs["conv", name]), args.reps)
                for name in CONV_VARIANTS}
        call(libs["conv", "base"])()
        torch.cuda.synchronize()
        site["base_rel_err"] = ((y - want).abs().max() / want.abs().max()).item()
        result[f"conv {label}"] = site
        print(f"conv {label}", json.dumps(site), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"card": chip_smoke.card_line(), "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
