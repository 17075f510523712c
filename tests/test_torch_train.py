"""The port's training stack (sdmatte_tpu_torch/parallel/train.py) against
the JAX package's (sdmatte_tpu/parallel/train.py) on the tiny config.

Both packages get the same weights (``sdmatte.init`` inflated to O(1)
activations, carried across by checkpoint/convert.py), the same composite
batches (the JAX sampler's, NHWC, and the port's NCHW copies) and the same
teacher features, fp32 at 64 px.  The JAX side runs as its own training
does (``attn_impl="xla"``), the port its plain versions.  Bars:
  * the uncertainty band: exact
  * the LR schedule: rtol 1e-7 against optax at every step
  * the optimizer: parameters within 1e-6 of optax's after three updates
  * the loss: rtol 1e-5; its gradients per leaf within
    ||g_port - g_jax|| <= 1e-3 ||g_jax|| + 1e-5 sqrt(n) (see _close_grads)
  * three train steps: losses rtol 1e-4; the parameter updates within
    ||d_port - d_jax|| / ||d_jax|| <= 1e-2 (see _close_updates)
The data-parallel step runs in two gloo processes (torch.multiprocessing),
each with one sample of the batch, and must equal the one-process step at
batch 2 and the JAX package's unsharded one at the loss bars.
"""

import dataclasses
import functools
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from sdmatte_tpu.configs import SDMatteConfig as JaxSDMatteConfig
from sdmatte_tpu.parallel import train as jax_train
from sdmatte_tpu.parallel.data import CompositeSampler as JaxSampler
from test_torch_models import _randomized_params

from sdmatte_tpu_torch.checkpoint.convert import load_params, params_to_state_dict
from sdmatte_tpu_torch.configs import SDMatteConfig
from sdmatte_tpu_torch.models.sdmatte import SDMatte
from sdmatte_tpu_torch.ops.dispatch import implementation
from sdmatte_tpu_torch.parallel import checkpointing, train
from sdmatte_tpu_torch.parallel.data import CompositeSampler, to_tensors

# every term on; the distillation term reads the use_dis_loss feature maps.
# Its weight keeps it of the order of the other terms: the random model's
# feature maps reach |f| ~ 10 and agree with the JAX package's to ~5e-5
# relative (the block bar), which a dominant squared distance would carry
# into the loss above its bar.
WEIGHTS = dict(l1=1.0, unknown_l1=1.0, grad_l1=0.5, dis=0.02)
LOSS, JAX_LOSS = train.LossConfig(**WEIGHTS), jax_train.LossConfig(**WEIGHTS)
# warmup 0: the first of the three steps already moves the parameters
SCHEDULE = dict(warmup_steps=0, total_steps=10)
LR = 1e-3


def _tree_to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def setup():
    """Weights, three composite batches with teacher features, for both
    packages."""
    jcfg = dataclasses.replace(JaxSDMatteConfig.tiny(), use_dis_loss=True)
    cfg = dataclasses.replace(SDMatteConfig.tiny(), use_dis_loss=True)
    params = _tree_to_numpy(_randomized_params(jcfg, seed=2))
    model = load_params(SDMatte(cfg), params)
    sampler = JaxSampler(size=64, seed=0)
    rng = np.random.default_rng(9)
    jax_batches, port_batches = [], []
    for _ in range(3):
        b = sampler.batch(2)
        pb = to_tensors(b)
        with torch.no_grad(), implementation("plain"):
            _, feats = model(pb)
        teacher = [rng.normal(0, 1, tuple(f.shape)).astype(np.float32) for f in feats]
        pb["teacher_features"] = [torch.from_numpy(t) for t in teacher]
        b["teacher_features"] = [t.transpose(0, 2, 3, 1) for t in teacher]
        jax_batches.append(b)
        port_batches.append(pb)
    return jcfg, cfg, params, jax_batches, port_batches


def _close_grads(got, ref, name):
    """A gradient leaf against the JAX package's: the L2 norm of the
    difference within 1e-3 of the reference's norm plus an RMS of 1e-5.

    Not the elementwise remat bars (atol 1e-5, rtol 1e-4), which hold JAX
    against itself: through the whole model (decoder, U-Net, and the encoder
    when trained) the random tiny model's gradients are ill-conditioned in
    fp32.  A 1e-7 relative perturbation of the input moves JAX's own
    gradients by up to 8e-5 of a leaf's scale, and the two packages' fp32
    forwards already differ by ~5e-5 relative (the block bar), so the
    deepest leaves differ by up to ~4e-4 of their scale, which would break
    those bars by up to 3x on a few leaves."""
    diff = float(torch.linalg.vector_norm(got.double() - ref.double()))
    bound = 1e-3 * float(torch.linalg.vector_norm(ref.double())) + 1e-5 * ref.numel() ** 0.5
    assert diff <= bound, (name, diff, bound)


def _port_model(setup):
    _, cfg, params, _, _ = setup
    return load_params(SDMatte(cfg), params)


@pytest.fixture(scope="module")
def jax_value_and_grad(setup):
    """frozen -> (loss, gradients as a torch state dict) of JAX's
    value_and_grad(matting_loss) on the first batch, each compiled once."""
    jcfg, _, params, jax_batches, _ = setup
    cache = {}

    def get(frozen):
        if frozen not in cache:
            fn = jax.jit(lambda p, b: jax.value_and_grad(jax_train.matting_loss)(
                p, jcfg, b, loss_cfg=JAX_LOSS, frozen=frozen))
            loss, grads = fn(params, jax_batches[0])
            cache[frozen] = (float(loss), params_to_state_dict(_tree_to_numpy(grads)))
        return cache[frozen]
    return get


@pytest.fixture(scope="module")
def jax_steps(setup):
    """Three of JAX's train_steps: the losses and the parameters after each."""
    jcfg, _, params, jax_batches, _ = setup
    tx, opt = jax_train.init_train_state(
        params, jax_train.make_lr_schedule(LR, **SCHEDULE))
    step = jax.jit(functools.partial(jax_train.train_step, cfg=jcfg, tx=tx,
                                     loss_cfg=JAX_LOSS))
    p, losses, after = params, [], []
    for b in jax_batches:
        p, opt, loss = step(p, opt, b)
        losses.append(float(loss))
        after.append(params_to_state_dict(_tree_to_numpy(p)))
    return losses, after


@pytest.fixture(scope="module")
def port_steps(setup):
    """Three of the port's train_steps: the losses, the parameters after
    each, and the first step's gradients (before clipping)."""
    port_batches = setup[4]
    model = _port_model(setup)
    state = train.init_train_state(model, train.make_lr_schedule(LR, **SCHEDULE))
    losses, after, grads = [], [], None
    for b in port_batches:
        loss = train.loss_and_grads(state, b, loss_cfg=LOSS)
        if grads is None:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()
                     if p.grad is not None}
        train.apply_gradients(state)
        losses.append(float(loss))
        after.append({k: v.clone() for k, v in model.state_dict().items()})
    return losses, after, grads


# ------------------------------------------------------------------ loss ---

@pytest.mark.parametrize("width", [7, 15])
def test_uncertainty_weight_matches_jax(width):
    rng = np.random.default_rng(width)
    alpha = rng.choice([0.0, 1.0, 0.5, 1e-3, 0.999], (2, 40, 33, 1),
                       p=[0.45, 0.45, 0.04, 0.03, 0.03]).astype(np.float32)
    ref = np.asarray(jax_train.uncertainty_weight(jnp.asarray(alpha), width=width))
    got = train.uncertainty_weight(torch.from_numpy(alpha).permute(0, 3, 1, 2), width=width)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    assert 0 < ref.sum() < ref.size


def test_grad_l1_differences_the_spatial_axes():
    """The port's alpha is NCHW (B, 1, S, S): the finite differences run over
    dims 2 and 3 and equal the JAX term's over NHWC axes 1 and 2 (a literal
    copy would difference the channel axis of size 1: a NaN)."""
    rng = np.random.default_rng(1)
    pred, gt = (rng.uniform(0, 1, (2, 24, 20, 1)).astype(np.float32) for _ in range(2))
    ref = float(jax_train._grad_l1(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(train._grad_l1(*(torch.from_numpy(x).permute(0, 3, 1, 2) for x in (pred, gt))))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


@pytest.mark.parametrize("frozen", [train.FROZEN_TOWERS, ()], ids=["frozen", "train_all"])
def test_matting_loss_matches_jax(setup, jax_value_and_grad, frozen):
    port_batches = setup[4]
    ref_loss, ref_grads = jax_value_and_grad(frozen)
    model = _port_model(setup)
    loss = train.matting_loss(model, port_batches[0], loss_cfg=LOSS, frozen=frozen)
    loss.backward()
    np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
    assert all(p.requires_grad for p in model.parameters())    # flags restored
    for name, p in model.named_parameters():
        ref = ref_grads[name]
        if name.split(".")[0] in frozen:
            assert p.grad is None, name
        if p.grad is None:      # frozen, or not reached: JAX's gradient is zero
            np.testing.assert_array_equal(ref.numpy(), 0.0, err_msg=name)
            continue
        _close_grads(p.grad, ref, name)
    assert (model.vae.encoder.conv_in.weight.grad is None) == bool(frozen)


# ------------------------------------------------------------ schedule ---

@pytest.mark.parametrize("lr,warmup,total", [
    (1e-4, 2, 4), (1e-4, 2, 20), (1e-4, 20, 200), (1e-3, 2, 30), (LR, 0, 10)])
def test_lr_schedule_matches_optax(lr, warmup, total):
    """The schedules examples/finetune.py makes (warmup max(2, steps // 10))
    and the tests' own, at every step and past the end."""
    ours = train.make_lr_schedule(lr, warmup_steps=warmup, total_steps=total)
    ref = jax_train.make_lr_schedule(lr, warmup_steps=warmup, total_steps=total)
    steps = np.arange(total + 3)
    np.testing.assert_allclose([ours(int(i)) for i in steps], np.asarray(ref(steps)),
                               rtol=1e-7, atol=0)
    if warmup:
        assert ours(0) == 0.0


def test_lr_schedule_long_within_one_float32_step():
    """make_lr_schedule's default length (10,000 steps).  The port rounds the
    cosine correctly; XLA's float32 cosine is off by one unit in the last
    place at a few counts, so here the bar is two units (2.4e-7)."""
    ours = train.make_lr_schedule(1e-5)
    ref = np.asarray(jax_train.make_lr_schedule(1e-5)(np.arange(10_003)))
    got = np.array([ours(i) for i in range(10_003)])
    np.testing.assert_allclose(got, ref, rtol=2 * 2.0 ** -23, atol=0)
    assert np.mean(got == ref) > 0.99


# ----------------------------------------------------------- optimizer ---

class _Towers(nn.Module):
    """A model with the towers train.FROZEN_TOWERS names."""

    def __init__(self):
        super().__init__()
        self.vae = nn.Linear(6, 5)
        self.unet = nn.Sequential(nn.Linear(5, 7), nn.Linear(7, 3))
        self.text_encoder = nn.Linear(4, 4)


def _nest(flat):
    tree = {}
    for name, v in flat.items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


@pytest.mark.parametrize("case", ["clip_active", "clip_inactive", "weight_decay", "frozen"])
def test_optimizer_matches_optax(case):
    """init_train_state + apply_gradients against the JAX package's optax
    chain (clip_by_global_norm -> adamw, frozen towers set to zero) on the
    same parameters and the same three gradient sets."""
    torch.manual_seed(0)
    model = _Towers()
    names = [n for n, _ in model.named_parameters()]
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    rng = np.random.default_rng(3)
    scale = 1e-3 if case == "clip_inactive" else 1.0
    grads = [{n: (scale * rng.normal(0, 1, v.shape)).astype(np.float32)
              for n, v in params.items()} for _ in range(3)]
    wd = 1e-2 if case == "weight_decay" else 0.0
    frozen = train.FROZEN_TOWERS if case == "frozen" else ()

    tx, opt = jax_train.init_train_state(
        _nest(params), jax_train.make_lr_schedule(1e-2, warmup_steps=1, total_steps=5),
        weight_decay=wd, frozen=frozen)
    update = jax.jit(tx.update)
    tree = _nest(params)
    norms = []
    for g in grads:
        trained = [v for n, v in g.items() if n.split(".")[0] not in frozen]
        norms.append(float(np.sqrt(sum(np.sum(v.astype(np.float64) ** 2) for v in trained))))
        upd, opt = update(_nest(g), opt, tree)
        tree = optax.apply_updates(tree, upd)
    ref = jax.tree_util.tree_map(np.asarray, tree)

    state = train.init_train_state(
        model, train.make_lr_schedule(1e-2, warmup_steps=1, total_steps=5),
        weight_decay=wd, frozen=frozen)
    for g in grads:
        for n, p in model.named_parameters():
            if p.requires_grad:
                p.grad = torch.from_numpy(g[n].copy())
        train.apply_gradients(state)

    assert (min(norms) > 1.0) if case != "clip_inactive" else (max(norms) < 1.0)
    for n, p in model.named_parameters():
        node = ref
        for k in n.split("."):
            node = node[k]
        np.testing.assert_allclose(p.detach().numpy(), node, atol=1e-6, rtol=0, err_msg=n)
        if n.split(".")[0] in frozen:
            np.testing.assert_array_equal(p.detach().numpy(), params[n])
            assert p not in state.optimizer.state
    assert len(state.optimizer.state) == len(state.trained) == sum(
        n.split(".")[0] not in frozen for n in names)


# -------------------------------------------------------------- steps ---

def _updates(after, before, names):
    return np.concatenate([(np.asarray(after[n]) - np.asarray(before[n])).ravel() for n in names])


def _close_updates(after, ref_after, before, names, lr=LR):
    """Parameter updates against a reference's: ||d - d_ref|| / ||d_ref||
    <= 1e-2, ten times the bar one would set for the parameters
    themselves.  Adam normalises each element by its own gradient's size,
    so an element's update carries its gradient's relative error, which is
    large where the gradient is small; and where a gradient near zero is
    rounded to opposite signs, the update moves by 2 lr.  Three steps
    here put 4-8 of the U-Net's 678k elements a full step apart and ~30-70
    more over 10% of a step, which alone makes the ratio ~5e-3.  The
    optimizer itself is held at 1e-6 by test_optimizer_matches_optax."""
    d, d_ref = _updates(after, before, names), _updates(ref_after, before, names)
    assert np.linalg.norm(d_ref) > 0
    rel = np.linalg.norm(d - d_ref) / np.linalg.norm(d_ref)
    assert rel <= 1e-2, rel


def test_train_steps_match_jax(setup, jax_steps, port_steps):
    params = setup[2]
    ref_losses, ref_after = jax_steps
    losses, after, _ = port_steps
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)
    before = params_to_state_dict(params)
    names = [n for n in before if n.startswith("unet.")]
    for i in range(3):
        _close_updates(after[i], ref_after[i], before, names)
    for n in before:    # the frozen towers, bit for bit
        if not n.startswith("unet."):
            torch.testing.assert_close(after[-1][n], before[n], rtol=0, atol=0)
            np.testing.assert_array_equal(ref_after[-1][n].numpy(), before[n].numpy())


def test_remat_matches_no_remat(setup):
    """Rematerialised U-Net blocks only trade memory for compute: the same
    loss (rtol 1e-6) and gradients (atol 1e-5, rtol 1e-4) as without."""
    port_batches = setup[4]
    out = []
    for remat in (False, True):
        model = _port_model(setup)
        loss = train.matting_loss(model, port_batches[1], loss_cfg=LOSS, remat=remat)
        loss.backward()
        out.append((loss.item(), {n: p.grad for n, p in model.named_parameters()
                                  if p.grad is not None}))
    (l0, g0), (l1, g1) = out
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    assert g0.keys() == g1.keys() and len(g0) > 0
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], atol=1e-5, rtol=1e-4)


# --------------------------------------------------------------- loop ---

def test_train_loop_checkpoints(setup, tmp_path):
    model = _port_model(setup)
    d = str(tmp_path / "ckpts")
    _, losses = train.train_loop(model, steps=3, batch_size=2,
                                 sampler=CompositeSampler(size=64, seed=4),
                                 learning_rate=1e-4, loss_cfg=LOSS, ckpt_dir=d,
                                 ckpt_every=2, log_every=1)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert checkpointing.latest_step(d) == 2


def test_train_loop_ema(setup, tmp_path):
    """ema_decay keeps an EMA of the weights: it lags the live weights
    toward the initial ones, is checkpointed beside them and restores
    (tests/test_parallel.py::test_train_loop_ema)."""
    model = _port_model(setup)
    init = model.unet.conv_in.weight.detach().clone()
    d = str(tmp_path / "ema_ckpts")
    model, losses, ema = train.train_loop(
        model, steps=3, batch_size=2, sampler=CompositeSampler(size=64, seed=5),
        learning_rate=1e-3, loss_cfg=LOSS, ema_decay=0.5, ckpt_dir=d, ckpt_every=3,
        log_every=1)
    live = model.unet.conv_in.weight.detach()
    avg = ema.unet.conv_in.weight.detach()
    assert bool(torch.isfinite(avg).all())
    assert float((avg - live).abs().max()) > 0
    assert float((avg - init).abs().mean()) < float((live - init).abs().mean())
    _, _, _, ema_sd = checkpointing.restore_train_state(d, with_ema=True)
    torch.testing.assert_close(ema_sd["unet.conv_in.weight"], avg, rtol=0, atol=0)


# ------------------------------------------------ data parallel, gloo ---

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dp_worker(rank, world, port, inputs, out_dir):
    """One process of the data-parallel step: its sample of the batch, the
    averaged gradients, the step."""
    torch.set_num_threads(1)
    from sdmatte_tpu_torch.parallel import mesh as pmesh
    assert pmesh.distributed_init(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        m = pmesh.make_mesh()
        blob = torch.load(inputs, weights_only=False)
        model = SDMatte(blob["cfg"])
        model.load_state_dict(blob["state"])
        state = train.init_train_state(model, train.make_lr_schedule(LR, **SCHEDULE))
        local = pmesh.shard_batch(blob["batch"], m)
        loss = train.loss_and_grads(state, local, loss_cfg=LOSS, group=pmesh.data_group(m))
        grads = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        train.apply_gradients(state)
        torch.save({"loss": float(loss), "grads": grads, "params": model.state_dict(),
                    "local_batch": local["image"].shape[0]},
                   os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        import torch.distributed as dist
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    """The data-parallel step on the first batch over two gloo processes."""
    _, cfg, params, _, port_batches = setup
    d = tmp_path_factory.mktemp("dp")
    inputs = str(d / "inputs.pt")
    torch.save({"cfg": cfg, "state": params_to_state_dict(params),
                "batch": port_batches[0]}, inputs)
    torch.multiprocessing.spawn(_dp_worker, args=(2, _free_port(), inputs, str(d)),
                                nprocs=2, join=True)
    return [torch.load(str(d / f"rank{r}.pt"), weights_only=False) for r in range(2)]


def test_data_parallel_step_matches_one_process(setup, world2, port_steps):
    """Two processes of batch 1 give the one-process step at batch 2: the
    global-batch loss (the unknown-band denominator all-reduced first), the
    same averaged gradients and the same parameters on both ranks."""
    losses, after, grads = port_steps
    assert [r["local_batch"] for r in world2] == [1, 1]
    for r in world2:
        np.testing.assert_allclose(r["loss"], losses[0], rtol=1e-5)
        assert r["grads"].keys() == grads.keys()
        for n, g in grads.items():
            torch.testing.assert_close(r["grads"][n], g, atol=1e-5, rtol=1e-4)
    for n, v in world2[0]["params"].items():
        torch.testing.assert_close(world2[1]["params"][n], v, rtol=0, atol=0)
    before = params_to_state_dict(setup[2])
    _close_updates(world2[0]["params"], after[0], before, list(grads))


def test_data_parallel_step_matches_jax(setup, world2, jax_value_and_grad, jax_steps):
    """... and JAX's unsharded step at batch 2."""
    params = setup[2]
    ref_loss, ref_grads = jax_value_and_grad(train.FROZEN_TOWERS)
    r = world2[0]
    np.testing.assert_allclose(r["loss"], ref_loss, rtol=1e-5)
    for n, g in r["grads"].items():
        _close_grads(g, ref_grads[n], n)
    before = params_to_state_dict(params)
    _close_updates(r["params"], jax_steps[1][0], before,
                   [n for n in before if n.startswith("unet.")])
