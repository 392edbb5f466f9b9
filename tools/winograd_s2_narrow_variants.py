"""Attribute the time of the f32 Winograd-DH form and the narrow stride-2 weight gradient on a CUDA GPU.

    python tools/winograd_s2_narrow_variants.py [--reps N]

Builds variants of ``unet3d_tpu_torch/ops/kernels/winograd_tf32x3.cu`` (the
``tf32x3`` form of Winograd-DH) and of ``s2_wgrad.cu`` (the ``narrow`` form
of s2_wgrad and the split-K sum) by text substitution into
``build/winograd_s2_narrow_variants/`` (one nvcc each, started together).
Winograd: ``base`` (the source as it is), ``one_product`` (hi*hi alone: a
third of the products), ``no_split`` (no cvt.rna: the raw f32 bits as hi,
lo zero), ``no_products`` (no wgmma), ``no_fold`` (the A^T fold left out),
``no_u2`` (no U2 slab loads after the first points), ``no_staging`` (no
window loads after the first chunk). s2_wgrad: ``base``, ``no_products`` (no
ldmatrix or mma), ``no_staging`` (no segment staged after the first two),
``no_sum`` (the split-K sum left out: the partial tiles alone). Each
variant's kernel is called through its own library with the wrapper's plan
and packing, on seeded N(0, 1) inputs, at the f32 Winograd sites of the
smoke (``chip_smoke.WINO_SHAPES``) and the narrow s2_wgrad sites
(``chip_smoke.NARROW_S2_SHAPES``), and timed by ``chip_smoke.device_ms``;
``base``'s error against the plain version is printed beside its time. The
s2_wgrad base is also timed at other splits (``--blocks-per-sm``: the
wrapper's target of blocks a SM). The variants other than ``base`` compute
wrong values by design. Prints the card and one JSON line. Needs a CUDA GPU
and nvcc.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "build", "winograd_s2_narrow_variants")

W_MMA = ("            WgmmaTf32<BN>::mma(alo[dx][ks], dhi, pacc, dx + ks > 0);\n"
         "            WgmmaTf32<BN>::mma(ahi[dx][ks], dlo, pacc);\n"
         "            WgmmaTf32<BN>::mma(ahi[dx][ks], dhi, pacc);\n")
W_SPLIT = ("          tf32_split(f_op(__uint_as_float(u[r]), __uint_as_float(v[r]), bt_add(jh)),\n"
           "                     ahi[dx][ks][r], alo[dx][ks][r]);")
WINO_VARIANTS = {
    "base": [],
    "one_product": [(W_MMA, "            WgmmaTf32<BN>::mma(ahi[dx][ks], dhi, pacc, dx + ks > 0);\n")],
    "no_split": [(W_SPLIT, "          { ahi[dx][ks][r] = __float_as_uint(f_op(__uint_as_float(u[r]), "
                           "__uint_as_float(v[r]), bt_add(jh))); alo[dx][ks][r] = 0u; }")],
    "no_products": [(W_MMA, "            if (a.n < 0) {\n" + W_MMA + "            }\n")],
    "no_fold": [("        fold(jd, jh);\n", "")],
    "no_u2": [("          load_slab(sb + k);", "          if (a.n < 0) load_slab(sb + k);")],
    "no_staging": [("if (first && c + 1 < a.chunks) load_window(",
                    "if (a.n < 0) load_window(")],
}
S2_VARIANTS = {
    "base": [],
    "no_products": [("    for (int ow0 = 0; ow0 < sw; ow0 += 16) {",
                     "    for (int ow0 = 0; ow0 < (a.n < 0 ? sw : 0); ow0 += 16) {")],
    "no_staging": [("    if (s + LEAD < steps) load_segment(", "    if (a.n < 0) load_segment(")],
    "no_sum": [("  return unet3d_s2_wgrad_sum_splits(part, dw, 27LL * a.cin * a.cout, splits, stream);\n}",
                "  return cudaSuccess;\n}")],
}


def build_variants():
    from unet3d_tpu_torch.kernels import build
    os.makedirs(OUT, exist_ok=True)
    nvcc = build.find_nvcc()
    procs = {}
    for kind, source, variants in (("wino", "winograd_tf32x3.cu", WINO_VARIANTS),
                                   ("s2", "s2_wgrad.cu", S2_VARIANTS)):
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
            cmd = [nvcc, *build.NVCC_FLAGS, "-I", str(build._KERNELS), "-shared",
                   "-o", os.path.join(OUT, f"lib{kind}_{name}.so"), cu]
            procs[kind, name] = (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                       stderr=subprocess.STDOUT, text=True))
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for (kind, name), (cmd, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {kind} {name}:\n{' '.join(cmd)}\n{output}")
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{kind}_{name}.so"))
        if kind == "wino":
            lib.unet3d_winograd_tf32x3.argtypes = [i, i, p, p, p, p] + [i] * 12 + [p]
            lib.unet3d_winograd_tf32x3.restype = i
        else:
            lib.unet3d_s2_wgrad_narrow.argtypes = [i, p, p, p, p] + [i] * 17 + [p]
            lib.unet3d_s2_wgrad_narrow.restype = i
        libs[kind, name] = lib
    return libs


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--blocks-per-sm", type=int, nargs="+", default=[1, 2, 3, 4, 8])
    parser.add_argument("--kernels", nargs="+", default=["winograd", "s2_wgrad"],
                        choices=["winograd", "s2_wgrad"])
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("winograd_s2_narrow_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from unet3d_tpu_torch.ops import s2_wgrad_kernel as S
    from unet3d_tpu_torch.ops import winograd_kernel as W

    libs = build_variants()
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    result = {}
    for label, s, cin, cout in chip_smoke.WINO_SHAPES * ("winograd" in args.kernels):
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen)
        w = torch.randn(3, 3, 3, cin, cout, device=device, generator=gen) / (27 * cin) ** 0.5
        want = W.winograd_reference(x, w)
        plan = W.tf32_plan(tuple(x.shape), cout)
        u2 = W.pack_u2_tf32(w, plan)
        y = torch.empty(1, s, s, s, cout, device=device)

        def call(lib):
            def run():
                err = lib.unet3d_winograd_tf32x3(
                    0, plan.config, x.data_ptr(), u2.data_ptr(), y.data_ptr(), None, 1, s, 1, 1,
                    s, s, cin, cout, plan.h_tiles, plan.w_tiles, plan.n_tiles, plan.chunks,
                    stream())
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return run

        site = {name: chip_smoke.device_ms(call(libs["wino", name]), args.reps)
                for name in WINO_VARIANTS}
        call(libs["wino", "base"])()
        torch.cuda.synchronize()
        site["base_rel_err"] = ((y - want).abs().max() / want.abs().max()).item()
        site["plan"] = plan._asdict()
        result[f"winograd f32 {label}"] = site
        print(f"winograd f32 {label}", json.dumps(site), flush=True)
        del x, w, want, u2, y
    for label, s, cin, cout in chip_smoke.NARROW_S2_SHAPES * ("s2_wgrad" in args.kernels):
        x = torch.randn(1, s, s, s, cin, device=device, generator=gen).bfloat16()
        g = torch.randn(1, s // 2, s // 2, s // 2, cout, device=device,
                        generator=gen).bfloat16()
        want = S.s2_wgrad_reference(x, g)
        dw = torch.empty((3, 3, 3, cin, cout), dtype=torch.float32, device=device)

        def call(lib, plan, part):
            def run():
                err = lib.unet3d_s2_wgrad_narrow(
                    plan.nt, x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), 1, s,
                    s, s, cin, s // 2, s // 2, s // 2, cout, plan.n_tiles, plan.chunks, plan.sw,
                    plan.lines, plan.segments, plan.splits, plan.per_split, 1, stream())
                if err:
                    raise RuntimeError(f"launch failed: {err}")
            return run

        plan = S.narrow_plan(tuple(x.shape), cout, sms)
        part = torch.empty((plan.splits, 27 * cin, cout), dtype=torch.float32, device=device)
        site = {name: chip_smoke.device_ms(call(libs["s2", name], plan, part), args.reps)
                for name in S2_VARIANTS}
        call(libs["s2", "base"], plan, part)()
        torch.cuda.synchronize()
        site["base_rel_err"] = ((dw - want).abs().max() / want.abs().max()).item()
        site["plan"] = plan._asdict()
        default = S._NARROW_BLOCKS_PER_SM
        for bps in args.blocks_per_sm:
            S._NARROW_BLOCKS_PER_SM = bps
            S.narrow_plan.cache_clear()
            other = S.narrow_plan(tuple(x.shape), cout, sms)
            scratch = torch.empty((other.splits, 27 * cin, cout), dtype=torch.float32,
                                  device=device)
            site[f"base_blocks_per_sm_{bps}"] = dict(
                splits=other.splits,
                ms=chip_smoke.device_ms(call(libs["s2", "base"], other, scratch), args.reps),
                no_sum_ms=chip_smoke.device_ms(call(libs["s2", "no_sum"], other, scratch),
                                               args.reps))
        S._NARROW_BLOCKS_PER_SM = default
        S.narrow_plan.cache_clear()
        result[f"s2_wgrad narrow {label}"] = site
        print(f"s2_wgrad narrow {label}", json.dumps(site), flush=True)
    print(chip_smoke.card_line())
    print(json.dumps({"card": chip_smoke.card_line(), "ms": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
