"""The port's data-parallel trainer on the CPU: ``make_train_step(cfg,
mesh)`` and ``train(use_mesh=True)`` over two gloo ranks
(``tests/torch_dist_worker.py``) against the port's single-device
``make_train_step`` on the same batches and weights.

v3 with dropout (the block, attention and drop-path masks) and v4 with its
aux losses (BatchNorm, Dropout2d). Tolerances (measured in brackets): the
step-0 loss within 1e-5 relative (the same float32 forward, its sums split
over two ranks); step 0's gradient, summed over the ranks, within 1e-5 of
each tensor's largest entry for v3 [2.0e-6], and the parameters after two
steps within 1e-4 of each tensor's RMS, as an RMS error [4.9e-5]. v4 is
held to 2e-3 on both [7.6e-4 and 9.7e-4]: its BatchNorm takes the fast
variance E[x²] − E[x]², whose cancellation makes its gradient sensitive to
the order of the batch sums; on one device, reversing the halves of the
batch moves the same gradient by 6.3e-4 of its largest entry. Excluded from
those bounds are the entries whose gradient is zero by symmetry (the key
third of each qkv bias, and the biases of the output projections and of
the aux heads' LayerNorm, which the loss's difference of embeddings
cancels: ``tests/test_torch_train.py``): Adam moves them by rounding noise
alone, so every entry is also held to the learning rate a step. The
dropout masks are identical; the BatchNorm running statistics those of the
global batch, within 1e-5.
"""

import dataclasses
import itertools
import warnings

import numpy as np
import pytest
import torch

from deepmerge_tpu_torch.config import (
    Config,
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from deepmerge_tpu_torch.geodata.synthetic import (
    generate_scene,
    make_training_pairs,
)
from deepmerge_tpu_torch.ops.dropout import dropout
from deepmerge_tpu_torch.train import loop
from deepmerge_tpu_torch.train.driver import train
from deepmerge_tpu_torch.train.sampler import PairSampler
from tests.torch_dist_worker import run_ranks

TINY = dict(input_image_scales=(16, 32, 64), cube=8, embed_dim=32,
            depth=(1, 1, 1), num_heads=4, out_dim=16, dtype="float32")
DATA = DataConfig(patch_sizes=(16, 32, 64), max_window=128, batch_size=8)
SCENE = dict(h=192, w=192, n_regions=40, n_objects=6, seed=7)
STEPS = 2
LR = 1e-4
CFGS = {
    "v3": Config(model=ModelConfig(variant="v3", drop_ratio=0.1,
                                   drop_path_ratio=0.0, **TINY),
                 data=DATA, train=TrainConfig(lr=LR)),
    "v4": Config(model=ModelConfig(variant="v4", **TINY), data=DATA,
                 train=TrainConfig(lr=LR, aux_weights=(0.1, 0.2))),
}
MASK_PAIRS = 6
GRAD_TOL = {"v3": 1e-5, "v4": 2e-3}
PARAM_RMS_TOL = {"v3": 1e-4, "v4": 2e-3}


def _pairs(scene):
    pos, neg = make_training_pairs(scene)
    return pos, neg, len(pos) + len(neg)


@pytest.fixture(scope="module")
def scene():
    return generate_scene(**SCENE)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, scene):
    n = _pairs(scene)[2]
    spec = dict(
        scene=SCENE, mask_pairs=MASK_PAIRS,
        dp={k: dict(cfg=c, steps=STEPS, epoch_seed=3,
                    steps_per_epoch=n // DATA.batch_size)
            for k, c in CFGS.items()},
        e2e=dict(cfg=dataclasses.replace(CFGS["v3"], train=TrainConfig(
            lr=LR, num_epochs=1, checkpoint_every=1)), steps=STEPS))
    return run_ranks("dp", 2, spec, tmp_path_factory.mktemp("dp"))


@pytest.fixture(scope="module")
def single(scene):
    """The single-device steps: the same weights (``create_train_state``
    from the config's seed), the same batches whole."""
    pos, neg, n = _pairs(scene)
    out = {}
    for name, cfg in CFGS.items():
        state = loop.create_train_state(cfg, n // DATA.batch_size,
                                        device="cpu")
        start = {k: v.clone() for k, v in state.model.state_dict().items()}
        step = loop.make_train_step(cfg)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            sampler = PairSampler(scene, pos, neg, cfg.data, "cpu")
        losses, grads = [], None
        for batch in itertools.islice(
                sampler.epoch_batches(3, DATA.batch_size), STEPS):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            if grads is None:
                grads = {k: p.grad.clone() for k, p in
                         state.model.named_parameters()
                         if p.grad is not None}
        out[name] = dict(losses=losses, grads=grads, start=start, state={
            k: v.detach().clone() for k, v in
            state.model.state_dict().items()})
    return out


def _symmetric(name: str, t: torch.Tensor) -> np.ndarray:
    """The entries of ``name`` whose gradient is zero by symmetry."""
    mask = np.zeros(tuple(t.shape), bool)
    if name.endswith("attn.qkv.bias"):
        d = t.shape[0] // 3
        mask[d: 2 * d] = True
    elif name.endswith(("final_features.bias",
                        "final_features_with_design.bias",
                        "out_features.bias")) or (
            name.startswith("aux") and name.endswith("norm.bias")):
        mask[:] = True
    return mask


def _compare(got, want, tol, rms=False):
    """Each float tensor of ``got`` against ``want`` off its symmetric
    entries: the largest error within ``tol`` of the largest entry, or with
    ``rms`` the RMS error within ``tol`` of the RMS. Returns the number of
    tensors compared."""
    n = 0
    for k, w in want.items():
        g = got[k]
        if not w.is_floating_point():
            torch.testing.assert_close(g, w, rtol=0, atol=0)
            continue
        sym = _symmetric(k, w)
        g, w = g.numpy()[~sym], w.numpy()[~sym]
        if not w.size:
            continue
        if rms:
            err, scale = (np.sqrt(np.mean(np.square(a))) for a in (g - w, w))
        else:
            err, scale = np.abs(g - w).max(), np.abs(w).max()
        assert err <= tol * scale, (k, err, scale)
        n += 1
    return n


def _check_params(got, want, start, tol):
    assert _compare(got, want, tol, rms=True) > 10
    for k, w in want.items():
        # Adam moves an entry by at most about the learning rate a step
        if w.is_floating_point():
            assert float((got[k] - w).abs().max()) <= 2 * LR * STEPS, k
    moved = sum(float((want[k] - start[k]).abs().max()) > 0 for k in start
                if want[k].is_floating_point())
    assert moved > 10


@pytest.mark.parametrize("variant", ["v3", "v4"])
def test_step0_loss_matches_single_device(ranks, single, variant):
    want = single[variant]["losses"]
    for out in ranks:
        got = out["dp"][variant]["losses"]
        assert len(got) == STEPS
        assert abs(got[0] - want[0]) <= 1e-5 * abs(want[0])
        assert abs(got[1] - want[1]) <= 1e-4 * abs(want[1])


@pytest.mark.parametrize("variant", ["v3", "v4"])
def test_gradient_is_the_whole_batch_gradient(ranks, single, variant):
    want = single[variant]["grads"]
    for out in ranks:
        got = out["dp"][variant]["grads"]
        assert set(got) == set(want)
        assert _compare(got, want, GRAD_TOL[variant]) > 10


@pytest.mark.parametrize("variant", ["v3", "v4"])
def test_params_after_two_steps_match_single_device(ranks, single, variant):
    for out in ranks:
        _check_params(out["dp"][variant]["state"], single[variant]["state"],
                      single[variant]["start"], PARAM_RMS_TOL[variant])


@pytest.mark.parametrize("variant", ["v3", "v4"])
def test_params_identical_across_ranks(ranks, variant):
    a, b = (out["dp"][variant]["state"] for out in ranks)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_batchnorm_statistics_are_the_global_batch(ranks, single):
    want = single["v4"]["state"]
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 4
    for out in ranks:
        got = out["dp"]["v4"]["state"]
        for k in keys:
            assert not torch.equal(want[k], single["v4"]["start"][k]), k
            torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6)


def test_dropout_masks_do_not_depend_on_the_world_size(ranks):
    """Each rank's mask is its rows of the single-device draw: the left
    and the right halves of the stacked [left; right] batch."""
    state = loop.create_train_state(CFGS["v3"], device="cpu")
    full = dropout(torch.ones(4 * MASK_PAIRS, 3, 5), 0.5,
                   loop._step_draws(state, None, 2 * MASK_PAIRS)[0]).numpy()
    halves = np.split(full, 2)
    for rank, out in enumerate(ranks):
        m = out["mask"]
        rows = slice(rank * MASK_PAIRS, (rank + 1) * MASK_PAIRS)
        np.testing.assert_array_equal(
            m["mask"], np.concatenate([halves[0][rows], halves[1][rows]]))
        assert m["scale"] == 0.5
    assert 0.3 < (full == 0).mean() < 0.7


def test_train_use_mesh_end_to_end(ranks, scene):
    """``train(use_mesh=True)``: the single-device ``train``'s parameters
    after the same steps, and only rank 0 writing its checkpoint and loss
    history."""
    cfg = dataclasses.replace(CFGS["v3"], train=TrainConfig(
        lr=LR, num_epochs=1, checkpoint_every=10 ** 6,
        checkpoint_tail_from=10 ** 6))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        state, history = train(cfg, scene=scene, max_steps_per_epoch=STEPS,
                               log_fn=lambda *_: None, device="cpu")
    start = loop.create_train_state(cfg, device="cpu").model.state_dict()
    for out in ranks:
        e2e = out["e2e"]
        assert e2e["step"] == state.step == STEPS
        np.testing.assert_allclose(e2e["losses"], history.train_losses,
                                   rtol=1e-5)
        _check_params(e2e["state"], state.model.state_dict(), start,
                      PARAM_RMS_TOL["v3"])
    assert ranks[0]["e2e"]["written"] == ["ck", "logs"]
    assert ranks[1]["e2e"]["written"] == []


@pytest.mark.parametrize("cmd", ["extract", "process-folder"])
def test_cli_mesh_refuses_stream_tiles(cmd, capsys):
    from deepmerge_tpu_torch.__main__ import main

    args = {"extract": ["extract", "--image", "x", "--polygons", "y",
                        "--points", "z"],
            "process-folder": ["process-folder", "--images", "x",
                               "--shapefiles", "y"]}[cmd]
    with pytest.raises(SystemExit) as e:
        main(["--device", "cpu", *args, "--mesh", "--stream-tiles", "2"])
    assert e.value.code == 2
    assert "--mesh and --stream-tiles are exclusive" in capsys.readouterr().err


@pytest.mark.parametrize("cmd", ["train", "extract", "process-folder"])
def test_cli_mesh_without_a_process_group(cmd, capsys, monkeypatch):
    """Outside torchrun there is no group to join: exit 2, naming how to
    start one."""
    from deepmerge_tpu_torch.__main__ import main

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    args = {"train": ["train"],
            "extract": ["extract", "--image", "x", "--polygons", "y",
                        "--points", "z"],
            "process-folder": ["process-folder", "--images", "x",
                               "--shapefiles", "y"]}[cmd]
    assert main(["--device", "cpu", *args, "--mesh"]) == 2
    err = capsys.readouterr().err
    assert "torchrun" in err and "process group" in err
