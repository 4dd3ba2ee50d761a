"""The port's stableadamw, sgd, automagic, muon, adafactor, adagrad and
genericoptim against the JAX package's optax transforms, gradient_release
and lr_scales against its gradient_release_step.

One tree of 1-D, 2-D and 3-D leaves, each in f32 and in bf16 (bf16
gradients, as a bf16 model gives them), three steps of seeded N(0, 1)
gradients, one jitted JAX update (JAX_FAST_COMPILE). Tolerances:
- f32 leaves within 4e-6 of max(1, |p|): the same f32 arithmetic in
  another order (XLA fuses multiply-adds; Adafactor's and GenericOptim's
  rsqrt / sqrt of ratios amplify a last-bit difference to ~1e-6 of an
  update of ~1). Muon's within 3e-5: its Newton-Schulz iterations run in
  bf16 for f32 parameters too, and torch's and XLA's CPU matmuls sum
  them in another order, so an orthogonalized entry (~0.2) differs by a
  bf16 ulp, ~1e-5 of a step at lr 1e-2;
- bf16 leaves within one bf16 ulp of each element: a last-bit difference
  in f32 can carry the rounded sum across a bf16 rounding boundary;
- stableadamw at eps 1e-3: at eps 1e-8 Adam's first update is +-1 in
  every element, and the RMS clip maps all of them to one quotient; where
  that sits at a bf16 rounding midpoint, all of them round one way in one
  framework and the other way in the other;
- automagic: also its int8 learning-rate codes, exactly (no element sits
  at a rounding edge in these three steps);
- genericoptim "topk" on the 2-D leaves only: the JAX projector fails to
  trace on a 3-D leaf.
The JAX package's right-side (tall kernel) projection fails on its
shapes; the port's tall case is held against the transpose of its wide
case, with the layout mapping (a port `weight` is the JAX kernel
transposed) that every layout-aware optimizer uses.

gradient_release at GAS 2: a linear model y = x W + b behind the same
minimal pipeline in both packages (prepare_inputs / forward / loss_fn),
adamw with clip 0.05 (active), lr_scales {"w": 0.5}: two steps, the
betas scaled to b ** (1/2), one update a micro-batch; loss and grad norm
rtol 1e-5, parameters within 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusion_pipe_tpu.training import optimizers as jopt
from diffusion_pipe_tpu.training.train_state import TrainState as JaxTrainState
from diffusion_pipe_tpu.training.trainer import make_train_step as jax_make_step
from diffusion_pipe_tpu_torch.training import optimizers as topt
from diffusion_pipe_tpu_torch.training.train_state import TrainState
from diffusion_pipe_tpu_torch.training.trainer import make_train_step
from torch_port_helpers import JAX_FAST_COMPILE, bf16_ulp
from torch_port_helpers import one_torch_thread  # noqa: F401

CASES = {
    "stableadamw": {"eps": 1e-3},
    "sgd": {"momentum": 0.9, "nesterov": True},
    "automagic": {"lr_bump": 1e-3},
    "muon": {},
    "adafactor": {},
    "adagrad": {},
    "genericoptim-svd": {"type": "genericoptim", "second_moment_type": "sn", "rank": 4,
                         "update_proj_gap": 2},
    "genericoptim-topk": {"type": "genericoptim", "rank": 4, "proj_type": "topk",
                          "update_proj_gap": 2},
}
SHAPES = {"v": (48,), "m": (32, 48), "s": (3, 16, 24)}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_steps_match(case):
    extra = dict(CASES[case])
    otype = extra.pop("type", case)
    cfg = {"optimizer": {"type": otype, "lr": 1e-2, "weight_decay": 0.1, **extra},
           "lr_scheduler": "cosine", "warmup_steps": 1, "_total_steps": 4}
    rng = np.random.default_rng(1)
    shapes = {k: v for k, v in SHAPES.items() if not (case == "genericoptim-topk" and k == "s")}
    names = [f"{k}_{d}" for d in ("f32", "bf16") for k in shapes]
    init = {n: rng.standard_normal(shapes[n.split("_")[0]]).astype(np.float32) for n in names}
    grads = [{n: rng.standard_normal(v.shape).astype(np.float32) for n, v in init.items()}
             for _ in range(3)]
    jdt = {n: jnp.bfloat16 if n.endswith("bf16") else jnp.float32 for n in names}
    tdt = {n: torch.bfloat16 if n.endswith("bf16") else torch.float32 for n in names}

    tx = jopt.get_optimizer(cfg)
    jparams = {n: jnp.asarray(v, jdt[n]) for n, v in init.items()}
    jstate = jax.jit(tx.init, compiler_options=JAX_FAST_COMPILE)(jparams)

    @functools.partial(jax.jit, compiler_options=JAX_FAST_COMPILE)
    def update(grads, state, params):
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state

    params = {n: torch.nn.Parameter(torch.from_numpy(v.copy()).to(tdt[n])) for n, v in init.items()}
    opt = topt.get_optimizer(cfg)(list(params.values()))
    for g in grads:
        jparams, jstate = update({n: jnp.asarray(v, jdt[n]) for n, v in g.items()}, jstate,
                                 jparams)
        for n, p in params.items():
            p.grad = torch.from_numpy(g[n]).to(tdt[n])
        opt.step()
    for n, p in params.items():
        assert p.dtype == tdt[n]
        got, want = p.detach().float().numpy(), np.asarray(jparams[n], np.float32)
        if n.endswith("f32"):
            atol = 3e-5 if otype == "muon" else 4e-6 * np.maximum(1.0, np.abs(want))
        else:
            atol = bf16_ulp(np.maximum(np.abs(got), np.abs(want)))
        bad = np.abs(got - want) > atol
        assert not bad.any(), (n, np.abs(got - want)[bad].max(), bad.mean())
        start = torch.from_numpy(init[n]).to(tdt[n]).float().numpy()
        # an update below half a bf16 ulp leaves a bf16 element as it was
        assert (got != start).mean() > (0.9 if n.endswith("f32") else 0.15), n
    if otype == "automagic":
        for i, (n, p) in enumerate(params.items()):
            want = np.asarray(jstate.lr_q[n])
            np.testing.assert_array_equal(opt.state[p]["lr_q"].numpy(), want, err_msg=n)


@pytest.mark.parametrize("otype, proj", [("automagic", None), ("muon", None),
                                         ("adafactor", None), ("genericoptim", "svd"),
                                         ("genericoptim", "uniform")])
def test_weights_take_the_jax_layout(otype, proj):
    """A port `weight` [out, in] steps as the JAX kernel [in, out] does: the
    named weight holding W^T moves to the transpose of W's trajectory (to
    1e-6: the reductions over a transposed view sum in another order), and
    (genericoptim, rank 4) a tall kernel to the transpose of the wide one
    (to 5e-5 abs / 1e-5 rel: LAPACK's SVD of W^T against that of W,
    amplified by the second moment's denominators; the "uniform"
    projector, which no JAX test can match, draws the same rows for
    both)."""
    cfg = {"optimizer": {"type": otype, "lr": 1e-2, "weight_decay": 0.1, "rank": 4,
                         "update_proj_gap": 2, "proj_type": proj or "svd"}}
    rng = np.random.default_rng(2)
    w = rng.standard_normal((12, 40)).astype(np.float32)
    grads = [rng.standard_normal(w.shape).astype(np.float32) for _ in range(3)]
    plain = torch.nn.Parameter(torch.from_numpy(w.copy()))
    named = torch.nn.Parameter(torch.from_numpy(np.ascontiguousarray(w.T)))
    tall = torch.nn.Parameter(torch.from_numpy(np.ascontiguousarray(w.T)))
    opt_plain = topt.get_optimizer(cfg)([plain])
    opt_named = topt.get_optimizer(cfg)([named], names=["block.proj.weight"])
    opt_tall = topt.get_optimizer(cfg)([tall], names=["block.proj.lora_a"])
    for g in grads:
        plain.grad = torch.from_numpy(g)
        named.grad = torch.from_numpy(np.ascontiguousarray(g.T))
        tall.grad = named.grad.clone()
        for o in (opt_plain, opt_named, opt_tall):
            o.step()
    torch.testing.assert_close(named.detach().t(), plain.detach(), rtol=1e-6, atol=1e-6)
    assert not torch.equal(plain.detach(), torch.from_numpy(w))
    if otype == "genericoptim":  # the tall (right-side) projection
        torch.testing.assert_close(tall.detach().t(), plain.detach(), rtol=1e-5, atol=5e-5)


def test_jax_layout_inverts_the_state_dict_mapping():
    """interop.jax_layout lays each port parameter out as its JAX leaf: a
    Dense kernel, a stacked block's Dense kernel and the Conv3d patch
    kernel come back bit for bit; the other leaves keep their layout."""
    from diffusion_pipe_tpu_torch import interop

    rng = np.random.default_rng(4)
    tree = {"proj": {"kernel": rng.standard_normal((6, 10)), "bias": rng.standard_normal(10),
                     "lora_a": rng.standard_normal((6, 2))},
            "patch_embedding": {"kernel": rng.standard_normal((1, 2, 2, 3, 8))},
            "blocks": {"ffn": {"kernel": rng.standard_normal((2, 8, 12))}}}
    sd = interop.jax_to_state_dict(tree)
    want = {"proj.weight": tree["proj"]["kernel"], "proj.bias": tree["proj"]["bias"],
            "proj.lora_a": tree["proj"]["lora_a"],
            "patch_embedding.weight": tree["patch_embedding"]["kernel"],
            **{f"blocks.{i}.ffn.weight": tree["blocks"]["ffn"]["kernel"][i] for i in range(2)}}
    assert set(sd) == set(want)
    for name, t in sd.items():
        perm = interop.jax_layout(name, t.dim())
        assert (perm is None) == (not name.endswith(".weight")), name
        got = t if perm is None else t.permute(perm)
        np.testing.assert_array_equal(got.numpy(), want[name], err_msg=name)


def test_optimizer_names_the_jax_package_resolves_in_optax_raise():
    with pytest.raises(NotImplementedError, match="lion"):
        topt.get_optimizer({"optimizer": {"type": "lion"}})


def test_lr_scale_paths_match_jax():
    names = ["double_blocks.0.attn_to_q.lora_a", "single_blocks.3.proj_mlp.lora_b",
             "x_embedder.weight"]
    scales = {"double_blocks": 0.5, "proj_mlp": 2.0}
    tree = {"params": {"double_blocks": {"attn_to_q": {"lora_a": jnp.ones(2)}},
                       "single_blocks": {"proj_mlp": {"lora_b": jnp.ones(2)}},
                       "x_embedder": {"kernel": jnp.ones(2)}}}
    out, _ = jopt.scale_updates_by_path(scales).update(tree, None)
    want = [float(out["params"]["double_blocks"]["attn_to_q"]["lora_a"][0]),
            float(out["params"]["single_blocks"]["proj_mlp"]["lora_b"][0]),
            float(out["params"]["x_embedder"]["kernel"][0])]
    assert topt.path_scales(names, scales) == want == [0.5, 2.0, 1.0]


# --- gradient_release -----------------------------------------------------------------


class _JaxLinear:
    def prepare_inputs(self, rng, batch, timestep_quantile=None):
        return {"x": batch["latents"]}, batch["y"], None

    def forward(self, params, inputs):
        return inputs["x"] @ params["params"]["w"] + params["params"]["b"]

    def loss_fn(self, out, target, mask):
        return jnp.mean((out - target) ** 2)


class _PortLinear:
    device = torch.device("cpu")

    def __init__(self, params):
        self.params = params

    def prepare_inputs(self, batch, generator=None, timestep_quantile=None, noise=None, t=None):
        return {"x": batch["latents"]}, batch["y"], None

    def forward(self, inputs):
        return inputs["x"] @ self.params["w"] + self.params["b"]

    def loss_fn(self, out, target, mask):
        return torch.mean((out - target) ** 2)


def test_gradient_release_matches_jax():
    cfg = {"optimizer": {"type": "adamw", "lr": 1e-2, "weight_decay": 0.1,
                         "gradient_release": True},
           "gradient_accumulation_steps": 2}
    scales = {"w": 0.5}
    rng = np.random.default_rng(3)
    w0 = rng.standard_normal((8, 4)).astype(np.float32)
    b0 = rng.standard_normal((4,)).astype(np.float32)
    batches = [{"latents": rng.standard_normal((4, 8)).astype(np.float32),
                "y": rng.standard_normal((4, 4)).astype(np.float32)} for _ in range(2)]

    tx = jopt.get_optimizer(cfg, lr_scales=scales)
    trainable = {"params": {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}}
    jstate = JaxTrainState(step=jnp.zeros([], jnp.int32), trainable=trainable, frozen={},
                           opt_state=tx.init(trainable), examples=jnp.zeros([], jnp.int32))
    jstep = jax.jit(functools.partial(
        jax_make_step(_JaxLinear(), tx, gradient_clipping=0.05, gradient_accumulation_steps=2,
                      gradient_release=True), rng=jax.random.PRNGKey(0)),
        compiler_options=JAX_FAST_COMPILE)

    params = {"w": torch.nn.Parameter(torch.from_numpy(w0.copy())),
              "b": torch.nn.Parameter(torch.from_numpy(b0.copy()))}
    opt = topt.get_optimizer(cfg, lr_scales=scales)(list(params.values()), names=list(params))
    assert opt.param_groups[0]["betas"] == (0.9 ** 0.5, 0.999 ** 0.5)
    state = TrainState(step=0, examples=0, trainable=params, optimizer=opt)
    step = make_train_step(_PortLinear(params), gradient_clipping=0.05,
                           gradient_accumulation_steps=2, gradient_release=True)
    for batch in batches:
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-5)
        assert float(jm["grad_norm"]) > 0.05  # the clip is active
    assert state.step == 2 and opt.state[params["w"]]["step"] == 4  # one update a micro-batch
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jstate.trainable["params"][k]),
                                   atol=1e-6, rtol=0, err_msg=k)


# --- every new option on tiny Flux and tiny Wan: construct, step, save -----------------

VARIANTS = {
    **{o: {"optimizer": {"type": o, "lr": 1e-3}}
       for o in ("stableadamw", "sgd", "automagic", "muon", "adamuon", "normuon",
                 "genericoptim", "adafactor", "adagrad")},
    "gradient_release": {"optimizer": {"type": "adamw8bit", "lr": 1e-3,
                                       "gradient_release": True},
                         "gradient_accumulation_steps": 2},
    "bypass_guidance": {"bypass_guidance_embedding": True},
    "lokr_dropout": {"adapter": {"type": "lokr", "rank": 4, "alpha": 4, "decompose_factor": -1,
                                 "rank_dropout": 0.5, "dropout": 0.1}},
    **{p: {"activation_checkpointing": p} for p in ("dots", "offload_attn", "unsloth",
                                                     "offload_dots")},
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tiny_configs_take_a_step_and_save(variant, tmp_path):
    """Each option builds a tiny Flux and a tiny Wan (LoRA r4, dropout
    0.1), takes one step (two micro-batches under gradient_release) that
    moves the adapter, and saves a checkpoint and the adapter; the
    checkpoint loads back into the same state."""
    from diffusion_pipe_tpu_torch.models import get_model_class
    from diffusion_pipe_tpu_torch.training.saver import Saver
    from diffusion_pipe_tpu_torch.training.train_state import lora_predicate
    from diffusion_pipe_tpu_torch.training.trainer import init_train_state

    extra = dict(VARIANTS[variant])
    rng = np.random.default_rng(0)
    for family in ("flux", "wan"):
        model = {"type": family, "dtype": "float32", "_tiny": True}
        if extra.pop("bypass_guidance_embedding", False) or variant == "bypass_guidance":
            model["bypass_guidance_embedding"] = True
        cfg = {"save_every_n_epochs": 1, "model": model,
               "adapter": {"type": "lora", "rank": 4, "alpha": 4, "dropout": 0.1},
               "optimizer": {"type": "adamw8bit", "lr": 1e-3}, **extra}
        gas = int(cfg.get("gradient_accumulation_steps", 1))
        pipe = get_model_class(family)(cfg, device="cpu")
        state = init_train_state(pipe, topt.get_optimizer(cfg), torch.Generator().manual_seed(0),
                                 lora_predicate)
        start = {n: p.detach().clone() for n, p in state.trainable.items()}
        if family == "flux":
            batch = {"latents": rng.standard_normal((gas, 16, 4, 4)),
                     "t5_embed": rng.standard_normal((gas, 4, 64)),
                     "clip_embed": rng.standard_normal((gas, 32))}
        else:
            batch = {"latents": rng.standard_normal((gas, 16, 1, 4, 4)),
                     "text_embeddings": rng.standard_normal((gas, 4, 32))}
        batch = {k: torch.from_numpy(v.astype(np.float32)) for k, v in batch.items()}
        step = make_train_step(pipe, gradient_accumulation_steps=gas,
                               gradient_release=bool(cfg["optimizer"].get("gradient_release")))
        m = step(state, batch, torch.Generator().manual_seed(1))
        assert np.isfinite(m["loss"].item()) and np.isfinite(m["grad_norm"].item())
        assert any(not torch.equal(p, start[n]) for n, p in state.trainable.items())
        saver = Saver(cfg, tmp_path / family, pipe)
        saver.save_checkpoint(state, 1)
        saver.save_model("step1", state)
        assert (tmp_path / family / "step1" / "adapter_model.safetensors").exists()
        moved = {n: p.detach().clone() for n, p in state.trainable.items()}
        with torch.no_grad():
            for p in state.trainable.values():
                p.zero_()
        saver.load_checkpoint(state, 1)
        assert all(torch.equal(p, moved[n]) for n, p in state.trainable.items())
