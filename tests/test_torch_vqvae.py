"""The port's VQVAE against the JAX package's, the ``codebook`` collection
carried both ways.

Structure at the JAX defaults (``jax.eval_shape`` of its init: no compile):
the port's ``params`` and ``codebook`` names and shapes are JAX's, the
codebook in buffers. Numerics at channel 8, one res block of 4, a 16 x
4-d codebook, on (2, 16^3, 2) inputs (the size of
``tests/test_model_zoo.py``), from seeded numpy variables (every kernel,
bias and codebook entry off its initial value; the cluster sizes positive),
JAX's results of each dtype from one jitted computation compiled without
XLA's excess precision (the port rounds every bf16 op):

- the eval forward, its codes and ``diff``; the training forward with its
  codebook update and the gradients of ``sum(out * g) + diff``, in f32
  (relative L2 1e-5 on outputs and codebook, 1e-4 on gradients; the codes
  equal) and in bf16 AMP (the train step's cast: bf16 parameters and input,
  f32 codebook; the eval cast makes the codebook bf16 too). The bf16 codes
  are the argmin of bf16 distances, where a rounding can flip a near tie:
  at this seed all of them agree (the share is asserted at least 0.99),
  and the outputs lie within 1e-2 of JAX's bf16 ones;
- one SGD step of ``make_train_step`` in 2 microbatches against JAX's scan
  (MSELoss on the input plus ``diff``): the loss, the parameters and the
  codebook, which the second microbatch takes from the first;
- ``decode_code``, the dtype of every module's output under both AMP casts
  (Flax's captured intermediates), the checkpoints both ways, ``--dry_run``
  putting the codebook back, and the predict CLI of both packages on a
  one-channel config (the JAX CLI sizes its init from ``in_channels``, 1
  when the config names none, while the port builds the encoder for
  ``in_channel``).
"""
import copy
import functools
import json
import os

import numpy as np
import pytest
import torch
from torch.func import functional_call

import jax
import jax.numpy as jnp
from flax.traverse_util import flatten_dict, unflatten_dict

from unet3d_tpu.config import factory as jax_factory
from unet3d_tpu.data import nifti as jax_nifti
from unet3d_tpu.models.registry import create_model as jax_create_model
from unet3d_tpu.models.vqvae2 import VQVAE as JaxVQVAE
from unet3d_tpu.scripts import predict as jax_predict
from unet3d_tpu.train import checkpoint as jax_ckpt
from unet3d_tpu.train import losses as jax_losses
from unet3d_tpu.train import step as jax_step

from unet3d_tpu_torch.config.factory import build_or_load_model_from_config
from unet3d_tpu_torch.convert import buffer_collections, load_jax_variables, model_variables
from unet3d_tpu_torch.models.layers import init_parameters
from unet3d_tpu_torch.models.registry import create_model
from unet3d_tpu_torch.models.vqvae2 import VQVAE
from unet3d_tpu_torch.scripts import predict
from unet3d_tpu_torch.scripts.train import dry_run_step
from unet3d_tpu_torch.train import losses, optim, step
from unet3d_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from test_torch_batchnorm import few_threads  # noqa: F401 (autouse)
from test_torch_batchnorm import LR, _sgd_keeping_grads
from test_torch_cli import BRATS, IMAGES
from test_torch_myronenko import _all, _cast, _flat, _rel, _x
from test_torch_resnet import EXACT_BF16, jax_tree_shapes

KWARGS = dict(in_channel=2, channel=8, n_res_block=1, n_res_channel=4, embed_dim=4,
              n_embed=16)
SHAPE = (2, 16, 16, 16, 2)
F32, F32_GRAD, BF16 = 1e-5, 1e-4, 1e-2


def vq_variables(jmod, shape, seed=0):
    """Seeded numpy variables in the names and shapes of ``jmod``'s tree:
    kernels normal with variance 1 / fan-in, biases 0.1 normal, codebooks
    and their averages standard normal, cluster sizes in [0.5, 1.5)."""
    shapes = jax.eval_shape(lambda: jmod.init({"params": jax.random.PRNGKey(0)},
                                              jnp.zeros(shape)))
    rng = np.random.RandomState(seed + 11)
    flat = {}
    for k, v in sorted(flatten_dict(shapes).items()):
        s, leaf = v.shape, k[-1]
        if leaf == "kernel":
            value = rng.randn(*s) / np.sqrt(np.prod(s[:-1]))
        elif leaf == "bias":
            value = 0.1 * rng.randn(*s)
        elif leaf == "cluster_size":
            value = 0.5 + rng.rand(*s)
        else:  # embed, embed_avg
            value = rng.randn(*s)
        flat["/".join(k)] = value.astype(np.float32)
    return flat


def _tree(flat, dtype=np.float32):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v.astype(dtype))
                           for k, v in flat.items()})


class Case:
    """The small VQVAE: JAX module and variables, input, cotangent, the
    port's model; JAX's results per dtype, computed once."""

    def __init__(self):
        self.jmod = JaxVQVAE(**KWARGS)
        self.flat = vq_variables(self.jmod, SHAPE)
        self.x = _x(*SHAPE, seed=1)
        self.g = (np.random.RandomState(2).randn(*SHAPE)
                  / np.sqrt(np.prod(SHAPE[1:]))).astype(np.float32)

    def port(self):
        return load_jax_variables(VQVAE(**KWARGS), self.flat, strict=True)

    @functools.lru_cache(maxsize=None)
    def jax(self, amp):
        jmod = self.jmod

        def run(v, x, g):
            cast = _cast if amp else (lambda t: t)
            xx = x.astype(jnp.bfloat16) if amp else x
            ev = cast(v)   # the eval cast: every f32 leaf, the codebook too
            out = {}
            out["eval"], out["eval_diff"] = jmod.apply(ev, xx, False)
            *_, out["eval_t"], out["eval_b"] = jmod.apply(ev, xx, False, method=JaxVQVAE.encode)
            train_v = lambda p: {"params": cast(p), "codebook": v["codebook"]}  # noqa: E731

            def loss(p):
                (rec, diff), upd = jmod.apply(train_v(p), xx, True, mutable=["codebook"])
                return (jnp.sum(rec.astype(jnp.float32) * g) + diff.astype(jnp.float32),
                        (rec, diff, upd["codebook"]))

            (_, (out["train"], out["diff"], out["codebook"])), out["grads"] = \
                jax.value_and_grad(loss, has_aux=True)(v["params"])
            (*_, out["train_t"], out["train_b"]), _ = jmod.apply(
                train_v(v["params"]), xx, True, method=JaxVQVAE.encode, mutable=["codebook"])
            out["decoded"] = jmod.apply(ev, out["eval_t"], out["eval_b"],
                                        method=JaxVQVAE.decode_code)
            return out

        out = jax.jit(run, compiler_options=EXACT_BF16)(
            _tree(self.flat), jnp.asarray(self.x), jnp.asarray(self.g))
        out["codebook"] = _flat({"codebook": out["codebook"]})
        out["grads"] = {k.replace("/", "."): a for k, a in _flat(out["grads"]).items()}
        return {k: v if isinstance(v, dict) else np.asarray(v, np.float32 if
                                                            v.dtype == jnp.bfloat16 else None)
                for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _case():
    return Case()


def test_structure_matches_jax():
    """At the defaults (4 channels in), the port's ``params`` and
    ``codebook`` keys and shapes are JAX's, the codebook in buffers of the
    ``codebook`` collection; a tree of those shapes loads strictly."""
    kwargs = dict(in_channel=4)
    want = jax_tree_shapes(jax_create_model("VQVAE", **kwargs), (1, 32, 32, 32, 4))
    model = create_model("VQVAE", **kwargs)
    got = {k: tuple(v.shape) for k, v in model_variables(model).items()}
    assert got == want
    assert {k.split("/")[0] for k in want} == {"params", "codebook"}
    assert set(buffer_collections(model).values()) == {"codebook"}
    assert not any("embed" in name or "cluster" in name for name, _ in model.named_parameters())
    load_jax_variables(model, {k: np.full(s, 0.5, np.float32) for k, s in want.items()},
                       strict=True)
    assert all(bool((t == 0.5).all()) for t in model.state_dict().values())


def test_initialisers_follow_jax():
    """``embed`` a standard normal from the generator, ``cluster_size``
    zeros, ``embed_avg`` a copy of ``embed`` in memory of its own."""
    model = create_model("VQVAE", in_channel=1)
    init_parameters(model, torch.Generator().manual_seed(0))
    q = model.quantize_t
    assert q.embed.shape == (64, 512)
    assert abs(float(q.embed.mean())) < 0.02 and abs(float(q.embed.std()) - 1.0) < 0.02
    assert not bool(q.cluster_size.any())
    assert torch.equal(q.embed_avg, q.embed) and q.embed_avg.data_ptr() != q.embed.data_ptr()
    assert not torch.equal(model.quantize_b.embed, q.embed)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_eval_forward_matches_jax(amp):
    c = _case()
    j = c.jax(amp)
    model = c.port()
    net = copy.deepcopy(model).to(torch.bfloat16) if amp else model  # make_forward's cast
    x = torch.from_numpy(c.x)
    x = x.to(torch.bfloat16) if amp else x
    with torch.no_grad():
        rec, diff = net(x)
        _, _, _, id_t, id_b = net.encode(x)
    assert rec.dtype == (torch.bfloat16 if amp else torch.float32)
    for got, want in ((id_t, j["eval_t"]), (id_b, j["eval_b"])):
        share = float((got.numpy() == want).mean())
        assert share == 1.0 if not amp else share >= 0.99, share
    bound = BF16 if amp else F32
    assert _rel(rec.float().numpy(), j["eval"]) < bound
    assert abs(float(diff) - float(j["eval_diff"])) <= bound * abs(float(j["eval_diff"]))


def _port_train(c, amp):
    """The training forward as the AMP train step runs it (bf16 copies of
    the parameters, the f32 codebook), the gradients of ``sum(out * g) +
    diff``, the codebook it leaves and the codes of both levels."""
    model = c.port()
    params = dict(model.named_parameters())
    call = {k: p.to(torch.bfloat16) for k, p in params.items()} if amp else params
    codes = {}
    for name in ("quantize_t", "quantize_b"):
        getattr(model, name).register_forward_hook(
            lambda m, i, o, name=name: codes.__setitem__(name, o[2].numpy()))
    x = torch.from_numpy(c.x)
    rec, diff = functional_call(model, call, (x.to(torch.bfloat16) if amp else x,),
                                {"train": True})
    ((rec.float() * torch.from_numpy(c.g)).sum() + diff.float()).backward()
    codebook = {k: v for k, v in model_variables(model).items() if k.startswith("codebook/")}
    return (rec.detach(), diff.detach(), {k: p.grad.numpy() for k, p in params.items()},
            codebook, codes)


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "bf16"])
def test_training_forward_gradients_and_codebook_match_jax(amp):
    """The training forward's output (f32 in both dtypes: the f32 codebook
    promotes the quantised tensors), ``diff``, the gradients and the
    codebook after the EMA update; the codes the update used are JAX's."""
    c = _case()
    j = c.jax(amp)
    rec, diff, grads, codebook, codes = _port_train(c, amp)
    np.testing.assert_array_equal(codes["quantize_t"], j["train_t"])
    np.testing.assert_array_equal(codes["quantize_b"], j["train_b"])
    assert rec.dtype == torch.float32
    assert _rel(rec.numpy(), j["train"]) < F32
    assert abs(float(diff) - float(j["diff"])) <= F32 * abs(float(j["diff"]))
    keys = sorted(j["grads"])
    assert sorted(grads) == keys
    assert _rel(_all(grads, keys), _all(j["grads"], keys)) < (BF16 if amp else F32_GRAD)
    assert sorted(codebook) == sorted(j["codebook"])
    for key in codebook:
        assert _rel(codebook[key], j["codebook"][key]) < F32, key


def test_decode_code_matches_jax():
    """``decode_code`` of the eval forward's codes, from the codebooks."""
    c = _case()
    j = c.jax(False)
    model = c.port()
    with torch.no_grad():
        got = model.decode_code(torch.tensor(j["eval_t"]), torch.tensor(j["eval_b"]))
    assert got.shape == SHAPE
    assert _rel(got.numpy(), j["decoded"]) < F32


def test_train_step_in_two_microbatches_matches_jax():
    """One SGD step of ``make_train_step`` with ``grad_accum=2`` (MSELoss on
    the input, plus ``diff``) against the JAX step's scan: the mean loss, the
    parameters after the step and the codebook the second microbatch leaves
    after updating the first's."""
    c = _case()
    images = np.ascontiguousarray(np.moveaxis(c.x, -1, 1))
    tx = _sgd_keeping_grads(LR)
    state = jax_step.create_train_state(_tree(c.flat), tx)
    run = jax.jit(jax_step.train_step_body(c.jmod, jax_losses.MSELoss(), tx, grad_accum=2))
    state, want_loss = run(state, images, images)
    want = _flat({"params": state.params, **state.extra_variables})
    model = c.port()
    step_fn = step.make_train_step(model, losses.MSELoss(),
                                   optim.build_optimizer("SGD", model.parameters(), lr=LR),
                                   grad_accum=2)
    loss = float(step_fn(images, images))
    assert abs(loss - float(want_loss)) <= F32 * abs(float(want_loss))
    ours = model_variables(model)
    assert set(ours) == set(want)
    for group in ("params/", "codebook/"):
        keys = sorted(k for k in want if k.startswith(group))
        assert _rel(_all(ours, keys), _all(want, keys)) < F32, group
    # the second microbatch took the first's codebook: it moved twice
    one = c.port()
    with torch.no_grad():
        one(torch.from_numpy(c.x[:1]), True)
    assert _rel(ours["codebook/quantize_t/embed"],
                model_variables(one)["codebook/quantize_t/embed"]) > 1e-3


def _jax_dtypes(jmod, variables, x, train):
    cast = {"params": _cast(variables["params"]),
            "codebook": variables["codebook"] if train else _cast(variables["codebook"])}
    (_, state) = jax.jit(lambda v, xv: jmod.apply(
        v, xv, train, capture_intermediates=True, mutable=["intermediates", "codebook"]))(
        cast, jnp.asarray(x).astype(jnp.bfloat16))
    out = {}
    for path, value in flatten_dict(state["intermediates"]).items():
        if path[-1] == "__call__":
            value = value[0]
            value = value[0] if isinstance(value, tuple) else value
            out[".".join(path[:-1]) or "<model>"] = str(value.dtype)
    return out


def _torch_dtypes(model, x, train):
    if train:   # the train step's cast: parameters only
        net, params = model, {k: p.to(torch.bfloat16) for k, p in model.named_parameters()}
    else:       # the inference cast: the codebook too
        net, params = copy.deepcopy(model).to(torch.bfloat16), {}
    out, handles = {}, []
    for name, module in net.named_modules():
        def hook(m, inp, o, name=name):
            o = o[0] if isinstance(o, tuple) else o
            out[name or "<model>"] = str(o.dtype).replace("torch.", "")
        handles.append(module.register_forward_hook(hook))
    with torch.no_grad():
        functional_call(net, params, (torch.from_numpy(x).to(torch.bfloat16),),
                        {"train": train})
    for h in handles:
        h.remove()
    return out


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_amp_dtype_flow_matches_jax(train):
    """Under the train step's AMP cast the f32 codebook makes the quantised
    tensors f32, so ``dec_t``, ``quantize_conv_b``, ``upsample_t`` and ``dec``
    run in f32 on bf16 parameters; under the inference cast the codebook is
    bf16 and every module returns bf16. Every module's output dtype is
    JAX's."""
    c = _case()
    want = _jax_dtypes(c.jmod, _tree(c.flat), c.x, train)
    got = _torch_dtypes(c.port(), c.x, train)
    common = sorted(set(want) & set(got))
    assert len(common) > 25
    assert {k: got[k] for k in common} == {k: want[k] for k in common}
    assert got["enc_b.down1"] == got["enc_t.res0"] == got["quantize_conv_t"] == "bfloat16"
    late = ("quantize_t", "dec_t.conv", "dec_t.up1", "quantize_conv_b", "upsample_t", "dec.up2",
            "<model>")
    assert {got[k] for k in late} == {"float32" if train else "bfloat16"}


def test_checkpoints_carry_the_codebook_both_ways(tmp_path):
    """A JAX ``.npz`` (``params`` and ``codebook``) loads strictly into the
    port, every array equal; the port's save is read by JAX's loader with
    all of both collections, and reloads into a fresh model equal."""
    c = _case()
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(_tree(c.flat), path)
    flat = load_checkpoint(path)
    model = load_jax_variables(VQVAE(**KWARGS), flat, strict=True)
    ours = model_variables(model)
    assert set(ours) == set(flat) and any(k.startswith("codebook/") for k in flat)
    for key, value in flat.items():
        np.testing.assert_array_equal(ours[key], value)
    with torch.no_grad():
        model(torch.from_numpy(c.x), True)   # move the codebook off the file's
    saved = str(tmp_path / "port.npz")
    save_checkpoint(model, saved)
    theirs = _flat(jax_ckpt.load_into(_tree(c.flat), saved, strict=True))
    after = model_variables(model)
    assert set(theirs) == set(after)
    for key in after:
        np.testing.assert_array_equal(theirs[key], after[key])
    again = load_jax_variables(VQVAE(**KWARGS), load_checkpoint(saved), strict=True)
    for key, value in model_variables(again).items():
        np.testing.assert_array_equal(value, after[key])


def test_dry_run_puts_the_codebook_back(tmp_path):
    """``--dry_run`` runs the step's forwards and backwards and puts every
    buffer back: the codebook the training forward updated too."""
    c = _case()
    model = c.port()
    before = {k: v.copy() for k, v in model_variables(model).items()}
    images = np.ascontiguousarray(np.moveaxis(c.x, -1, 1))
    report = dry_run_step(str(tmp_path), [{"image": images, "label": images}], model,
                          losses.MSELoss(), False, torch.device("cpu"), grad_accum=2)
    assert report["gradient_accumulation_steps"] == 2
    for key, value in model_variables(model).items():
        np.testing.assert_array_equal(value, before[key], err_msg=key)


def test_predict_cli_matches_jax_at_one_channel(tmp_path):
    """Both predict CLIs on one checkpoint of a one-channel VQVAE config
    (``in_channel`` 1: the JAX CLI builds its encoder for ``in_channels``,
    which such a config leaves at 1), f32: the reconstructions of the
    fixture case agree. At 4 channels the port builds the encoder for 4,
    where the JAX factory's init would take 1."""
    model_cfg = {"name": "VQVAE", **dict(KWARGS, in_channel=1)}
    config = json.load(open(BRATS))
    config["model"] = model_cfg
    config["dataset"]["desired_shape"] = [16, 16, 16]
    config["training"]["amp"] = False
    config["test_filenames"] = [{"image": IMAGES[:1]}]
    del config["training_filenames"], config["bratsvalidation_filenames"], config["inference"]
    config_file = str(tmp_path / "config.json")
    json.dump(config, open(config_file, "w"))
    jmod = JaxVQVAE(**dict(KWARGS, in_channel=1))
    flat = vq_variables(jmod, (1, 16, 16, 16, 1), seed=3)
    model_file = str(tmp_path / "model.npz")
    jax_ckpt.save_checkpoint(_tree(flat), model_file)
    with pytest.MonkeyPatch.context() as patch:
        # the JAX CLI's eager init compiles op by op; hand it the template
        patch.setattr(jax_factory, "init_params", lambda *a, **k: _tree(flat))
        jax_predict.main(["--config_filename", config_file, "--model_filename", model_file,
                          "--output_directory", str(tmp_path / "jax")])
    predict.main(["--config_filename", config_file, "--model_filename", model_file,
                  "--output_directory", str(tmp_path / "port")], device="cpu")
    (name,) = os.listdir(tmp_path / "jax" / "predictions")
    want, _, _ = jax_nifti.load(str(tmp_path / "jax" / "predictions" / name))
    got, _, _ = jax_nifti.load(str(tmp_path / "port" / "predictions" / name))
    source, _, _ = jax_nifti.load(IMAGES[0])
    assert got.shape == want.shape == source.shape   # one channel, on the source grid
    assert _rel(got, want) < 1e-4
    config["model"] = {"name": "VQVAE", "in_channel": 4, "channel": 8}
    port = build_or_load_model_from_config(config, None, torch.device("cpu"))
    assert tuple(port.enc_b.down1.kernel.shape) == (4, 4, 4, 4, 4)
    assert jax_factory.model_input_shape_from_config(config)[-1] == 1
