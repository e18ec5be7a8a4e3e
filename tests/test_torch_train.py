"""The port's training loop (train/loop.py) against the JAX package: the
rendered batch, one whole loss step with every parameter gradient, the
optimizer and schedule against optax, and mirrors of tests/test_train.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from dvsg_tpu.config import ModelConfig as JModelConfig
from dvsg_tpu.config import TrainConfig as JTrainConfig
from dvsg_tpu.models import motion_cnn as jcnn
from dvsg_tpu.ops import warp as jwarp
from dvsg_tpu.train import loop as jloop
from dvsg_tpu.train import synthetic as jsyn
from dvsg_tpu_torch.config import ModelConfig, TrainConfig
from dvsg_tpu_torch.models import motion_cnn as tcnn
from dvsg_tpu_torch.train import loop as tloop
from dvsg_tpu_torch.utils import checkpoint as tckpt

MKW = dict(window=3, model_size=(32, 32), grid_size=(8, 8),
           base_features=8, blocks_per_level=1, max_offset=0.15)
TKW = dict(batch_size=4, steps=60, warmup_steps=5, learning_rate=1e-3,
           checkpoint_every=0)
MCFG, JMCFG = ModelConfig(**MKW), JModelConfig(**MKW)
TCFG = TrainConfig(model=MCFG, **TKW)
JTCFG = JTrainConfig(model=JMCFG, **TKW)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small convolutions backward on many intra-op threads, in several
    test workers at once, oversubscribe the cores (minutes for one test);
    one thread is as fast alone and steady under load."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _jax_draws(keys, cfg):
    """The draws the reference's _sample_batch makes from ``keys``, by the
    same key derivation (fold_in 0 / 1 / 2): stills, paths, gains."""
    clip_len = cfg.model.window + jloop._STEPS_PER_CLIP - 1
    fold = lambda i: jax.vmap(lambda k: jax.random.fold_in(k, i))(keys)
    stills = jloop._draw_stills(fold(0), cfg, None)
    paths = jax.vmap(
        lambda k: jsyn.random_camera_path(k, clip_len))(fold(1))
    gains = 1.0 + 0.03 * jax.vmap(lambda k: jax.random.uniform(
        k, (clip_len,), minval=-1.0, maxval=1.0))(fold(2))
    return tuple(torch.from_numpy(np.array(a))
                 for a in (stills, paths, gains))


def _flat(params):
    leaves, _ = jax.tree_util.tree_flatten_with_path(params)
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.array(v)
            for path, v in leaves}


def _perturbed_params(seed):
    """A seeded flax init with numpy noise on every leaf, so that the zero
    head_out kernel does not silence the gradients of everything before
    it; returned as (flax tree, port state dict)."""
    params = jcnn.init_params(JMCFG, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    return params, tckpt.params_from_flax(_flat(params), MCFG)


def test_render_batch_matches_reference_sample_batch():
    keys = jax.random.split(jax.random.key(3), TCFG.batch_size)
    want = jloop._sample_batch(keys, JTCFG)
    got = tloop.render_batch(*_jax_draws(keys, JTCFG), TCFG)
    names = ("input_frames", "lasts", "target_frames", "target_offsets")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)
        assert not g.requires_grad


@pytest.mark.parametrize("impl", ["lax", "pallas_interpret"])
def test_loss_step_matches_reference(impl, monkeypatch):
    """One loss step on an identical batch and identical weights: the
    loss, every aux term and every parameter gradient against jax.grad of
    the reference's loss_fn — through its lax oracle and through its
    Pallas kernel (interpret mode) with the grid-only custom VJP."""
    monkeypatch.setattr(jwarp, "resolve_impl", lambda _: impl)
    jparams, tparams = _perturbed_params(1)
    keys = jax.random.split(jax.random.key(4), TCFG.batch_size)
    (want_total, want_aux), want_grads = jax.value_and_grad(
        jloop.loss_fn, has_aux=True)(jparams, keys, JTCFG)

    model = tcnn.MotionEstimator(MCFG)
    model.load_state_dict(tparams)
    model.train()
    batch = tloop.render_batch(*_jax_draws(keys, JTCFG), TCFG)
    total, aux = tloop.loss_from_batch(model, batch, TCFG)
    total.backward()

    # f32 means over ~25k elements in another order: rtol 1e-5. The Pallas
    # kernel's coordinate rounding (it adds its padding before taking the
    # fraction) moves its pixel term by up to 1e-4 relative.
    rtol = 1e-5 if impl == "lax" else 1e-4
    assert set(aux) == set(want_aux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k].detach()),
                                   float(want_aux[k]),
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(float(total.detach()), float(want_total),
                               rtol=rtol)

    want = tckpt.params_from_flax(_flat(want_grads), MCFG)
    named = dict(model.named_parameters())
    assert set(named) == set(want)
    worst = 0.0
    for name, p in named.items():
        assert p.grad is not None, name
        scale = float(want[name].abs().max())
        assert scale > 0, name
        worst = max(worst, float((p.grad - want[name]).abs().max()) / scale)
    # max-abs error over each tensor's largest gradient
    print(f"[{impl}] worst relative gradient error {worst:.2e}")
    assert worst < 1e-4


def test_optimizer_matches_optax_on_fixed_gradients():
    """Five AdamW updates on fixed gradient sequences against the
    reference's optax optimizer (decay on every parameter, eps outside the
    root, first update at rate 0)."""
    cfg = TrainConfig(model=MCFG, steps=20, warmup_steps=3,
                      learning_rate=1e-2, weight_decay=1e-2)
    jcfg = JTrainConfig(model=JMCFG, steps=20, warmup_steps=3,
                        learning_rate=1e-2, weight_decay=1e-2)
    rng = np.random.default_rng(0)
    init = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in init.items()} for _ in range(5)]

    jopt = jloop.make_optimizer(jcfg)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in init.items()}
    topt, tsched = tloop.make_optimizer(cfg, list(tparams.values()))
    for i, g in enumerate(grads):
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                  jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        tsched.step()
        for k in init:
            np.testing.assert_allclose(
                tparams[k].detach().numpy(), np.asarray(jparams[k]),
                rtol=0, atol=1e-6, err_msg=f"step {i} {k}")
        if i == 0:        # rate 0 on the first update: nothing moved
            assert np.array_equal(tparams["w"].detach().numpy(), init["w"])


@pytest.mark.parametrize("steps,warmup_steps", [(60, 5), (1000, 100),
                                                (4, 100), (1, 1)])
def test_schedule_matches_optax(steps, warmup_steps):
    cfg = TrainConfig(model=MCFG, steps=steps, warmup_steps=warmup_steps,
                      learning_rate=2e-4)
    warmup = min(warmup_steps, max(steps // 10, 1))
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=2e-4, warmup_steps=warmup,
        decay_steps=max(steps, warmup + 1), end_value=2e-4 * 0.05)
    for count in sorted({0, 1, warmup, (warmup + steps) // 2, steps - 1,
                         steps, steps + 5}):
        np.testing.assert_allclose(tloop.learning_rate_at(cfg, count),
                                   float(sched(count)), rtol=1e-5,
                                   atol=1e-12, err_msg=str(count))
    assert tloop.learning_rate_at(cfg, 0) == 0.0
    assert tloop.learning_rate_at(cfg, warmup) == pytest.approx(2e-4)


# --- mirrors of tests/test_train.py ------------------------------------------

def test_loss_decreases_overfit_one_batch():
    state = tloop.init_state(TCFG, _gen(0), device="cpu")
    first = None
    for _ in range(60):
        aux = tloop.train_step(state, _gen(7), TCFG)     # the same batch
        if first is None:
            first = float(aux["offset"])
    last = float(aux["offset"])
    assert last < first * 0.3, (first, last)


def test_train_step_updates_params():
    state = tloop.init_state(TCFG, _gen(1), device="cpu")
    before = {k: v.clone() for k, v in state.params.items()}
    for i in range(3):   # warmup rate starts at 0, so one step is a no-op
        aux = tloop.train_step(state, _gen(2 + i), TCFG)
    assert state.step == 3
    assert max(float((state.params[k] - before[k]).abs().max())
               for k in before) > 0
    assert np.isfinite(float(aux["total"]))


def test_checkpoint_roundtrip(tmp_path):
    params = tcnn.init_params(MCFG, _gen(3))
    tckpt.save_checkpoint(str(tmp_path / "c"), params, MCFG, step=7)
    restored, cfg2, step = tckpt.load_checkpoint(str(tmp_path / "c"))
    assert cfg2 == MCFG and step == 7
    assert set(restored) == set(params)
    for k in params:
        assert torch.equal(restored[k], params[k]), k


def test_checkpoint_latest_step(tmp_path):
    params = tcnn.init_params(MCFG, _gen(4))
    d = str(tmp_path / "c")
    assert tckpt.latest_step(d) is None
    tckpt.save_checkpoint(d, params, MCFG, step=1)
    tckpt.save_checkpoint(d, params, MCFG, step=5)
    assert tckpt.latest_step(d) == 5
    with pytest.raises(FileNotFoundError):
        tckpt.load_checkpoint(str(tmp_path / "none"))


def test_full_train_state_resume_keeps_optimizer(tmp_path):
    """A resumed state carries the Adam moments and the schedule position:
    finishing from the step-3 record is bit-identical to the uninterrupted
    run."""
    cfg = TrainConfig(model=MCFG, batch_size=4, steps=6, warmup_steps=2,
                      learning_rate=1e-3, checkpoint_every=3)
    d = str(tmp_path / "c")
    full = tloop.train(cfg, checkpoint_dir=d, log_every=0, device="cpu")
    latest = tloop.load_train_state(cfg, d, device="cpu")
    assert latest.step == 6
    resumed = tloop.load_train_state(cfg, d, device="cpu", step=3)
    assert resumed.step == 3
    moments = [s["exp_avg"] for s in resumed.optimizer.state.values()]
    assert moments and any(float(m.abs().max()) > 0 for m in moments)
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(
        tloop.learning_rate_at(cfg, 3))
    out = tloop.train(cfg, state=resumed, log_every=0, device="cpu")
    for k, v in full.params.items():
        assert torch.equal(v, out.params[k]), k


def test_params_only_resume_positions_the_schedule(tmp_path):
    cfg = TrainConfig(model=MCFG, batch_size=2, steps=4, warmup_steps=2,
                      learning_rate=1e-3, checkpoint_every=0)
    d = str(tmp_path / "c")
    tckpt.save_checkpoint(d, tcnn.init_params(MCFG, _gen(5)), MCFG, step=2)
    state = tloop.load_train_state(cfg, d, device="cpu")
    assert state.step == 2 and not state.optimizer.state
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        tloop.learning_rate_at(cfg, 2))
    other = TrainConfig(model=ModelConfig(**{**MKW, "window": 5}))
    with pytest.raises(ValueError, match="mismatch"):
        tloop.load_train_state(other, d, device="cpu")


def test_train_logs_and_history():
    cfg = TrainConfig(model=MCFG, batch_size=2, steps=3, warmup_steps=1,
                      learning_rate=1e-3, checkpoint_every=0)
    lines, history = [], []
    state = tloop.train(cfg, log_every=2, print_fn=lines.append,
                        device="cpu", history=history)
    assert state.step == 3 and len(history) == 3
    assert [ln.split()[1] for ln in lines] == ["0", "2"]
    assert all(np.isfinite(h["total"]) for h in history)
    # a run is a function of its seed
    again = []
    tloop.train(cfg, log_every=0, device="cpu", history=again)
    assert again == history


def test_train_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tloop.train(TrainConfig(model=MCFG, steps=1), log_every=0)


def test_training_after_inference_in_one_process():
    """The stabilizer runs under inference_mode and caches its resize
    matrices; a train step afterwards in the same process must be able to
    save them for backward."""
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.ops import resize as resize_ops
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    resize_ops._matrix_on.cache_clear()
    params = tcnn.init_params(MCFG, _gen(9))
    stab = Stabilizer(StabilizeConfig(model=MCFG, chunk_frames=4), params,
                      device="cpu")
    stab.stabilize_clip(np.zeros((4, 32, 32, 3), np.uint8))
    state = tloop.build_state(TCFG, params, device="cpu")
    aux = tloop.train_step(state, _gen(10), TCFG)
    assert np.isfinite(float(aux["total"]))


# --- init ----------------------------------------------------------------------

def test_init_head_out_is_zero_and_model_is_identity():
    from dvsg_tpu_torch.config import StabilizeConfig
    from dvsg_tpu_torch.pipeline.stabilize import Stabilizer
    params = tcnn.init_params(MCFG, _gen(6))
    assert torch.all(params["head_out.weight"] == 0)
    assert all(torch.all(v == 0) for k, v in params.items()
               if k.endswith(".bias"))
    assert all(torch.all(v == 1) for k, v in params.items()
               if v.dim() == 1 and k.endswith(".weight"))
    rng = np.random.default_rng(0)
    clip = rng.integers(0, 256, (5, 40, 56, 3), dtype=np.uint8)
    stab = Stabilizer(StabilizeConfig(model=MCFG, chunk_frames=4), params,
                      device="cpu")
    out = stab.stabilize_clip(clip)
    assert np.abs(out.astype(int) - clip).max() <= 1       # 1 LSB


def test_init_kernel_statistics():
    """Truncated-normal kernels with variance 1 / fan_in (the reference's
    default initializer), pooled over the wide layers."""
    cfg = ModelConfig()                                      # full width
    a = tcnn.init_params(cfg, _gen(7))
    for name, w in a.items():
        if w.dim() != 4 or name == "head_out.weight" or w.numel() < 20000:
            continue
        fan_in = w[0].numel()
        want = (1.0 / fan_in) ** 0.5
        assert float(w.std()) == pytest.approx(want, rel=0.05), name
        assert abs(float(w.mean())) < 0.05 * want, name
        assert float(w.abs().max()) <= 2.0 * want / 0.87962566 + 1e-6, name
    b = tcnn.init_params(cfg, _gen(7))
    assert all(torch.equal(a[n], b[n]) for n in a)
    # same structure and spread as the reference's init (small config)
    ours = tcnn.init_params(MCFG, _gen(8))
    ref = tckpt.params_from_flax(
        _flat(jcnn.init_params(JMCFG, jax.random.key(0))), MCFG)
    assert {k: tuple(v.shape) for k, v in ours.items()} \
        == {k: tuple(v.shape) for k, v in ref.items()}
    k = "head_conv2.weight"
    assert float(ours[k].std()) == pytest.approx(float(ref[k].std()),
                                                 rel=0.05)
    assert torch.all(ref["head_out.weight"] == 0)
