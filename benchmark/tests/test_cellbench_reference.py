"""The benchmark's plain references against gifgan_tpu_torch on the CPU at
a small size (widths 8, 32 px, 4 frames, float32): forward outputs,
losses and the first Adam steps. The references never import the
program; this test does, to hold the two together."""

import pytest
import torch

from benchmark import run as R
from benchmark.checks import train_steps
from benchmark.entries import _tree
from benchmark.tests.small import small_spec

VID = "vid_train_corpus_b256"
TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(name, seed=3):
    spec = small_spec(name)
    ref = R.load("reference", spec["config_name"])
    traffic, weights = R.cell_inputs(spec, seed, "cpu")
    entry = R.load("entries", spec["workload"]["entry"])
    return spec, ref, traffic, weights, entry


def test_vid_forward_passes():
    from gifgan_tpu_torch.models import dcgan, vid_dcgan

    spec, ref, traffic, weights, entry = _setup(VID)
    cfg = spec["config"]
    vcfg, _ = entry.program_configs(cfg, traffic.batch)
    tree = _tree.nest(weights)
    p, s = tree["params"], tree["state"]
    nets = {n: ref._net(weights, n) for n in
            ("vid_generator", "vid_discriminator", "img_generator",
             "img_discriminator")}
    z = traffic.next()["z"]
    g_out, _ = vid_dcgan.vid_generator(p["vid_generator"],
                                       s["vid_generator"], z, vcfg, True)
    torch.testing.assert_close(
        g_out, ref.vid_generator(nets["vid_generator"], z, cfg), **TOL)
    frames, _ = dcgan.generator(p["img_generator"], s["img_generator"],
                                g_out, vcfg.image_gan, train=False)
    torch.testing.assert_close(
        frames, ref.img_generator(nets["img_generator"], g_out, cfg), **TOL)
    tap, _ = dcgan.discriminator_tap(p["img_discriminator"],
                                     s["img_discriminator"], frames,
                                     vcfg.image_gan, train=False)
    torch.testing.assert_close(
        tap, ref.img_d_tap(nets["img_discriminator"], frames), **TOL)
    logits, _ = vid_dcgan.vid_discriminator(
        p["vid_discriminator"], s["vid_discriminator"], tap, vcfg, True)
    torch.testing.assert_close(
        logits, ref.vid_discriminator(nets["vid_discriminator"], tap, cfg),
        **TOL)


@pytest.mark.parametrize("name", [VID])
def test_steps_match(name):
    """The entry's first steps as the check reads them: the losses of each
    step and each leaf's first gradient of the D and of the G against the
    reference's. Their weights part after a step by up to a learning rate
    where a gradient is rounding alone (Adam's first update is lr times
    its sign), so the change is compared by the check's rule, not leaf by
    leaf."""
    spec, ref, traffic, weights, entry = _setup(name)
    cell = entry.Cell(spec["config"], traffic, weights, "cpu")
    prog = train_steps.during_setup(cell, traffic)
    want = ref.train_readings(weights, traffic.device_corpus(),
                              traffic.recorded, spec["config"])
    assert len(prog["loss"]) == len(want["loss"]) == 2 * train_steps.CHECKED
    torch.testing.assert_close(torch.tensor(prog["loss"]),
                               torch.tensor(want["loss"]), **TOL)
    nums = train_steps.numbers(prog, want, spec["workload"]["nets"])
    assert (nums["d_grad_gap"] < 1e-3 and nums["g_grad_gap"] < 1e-3
            and nums["change_gap"] < 0.05), nums


def test_adam_matches():
    """Two Adam updates of the program's optimizer and of the reference's
    on the same gradients."""
    from gifgan_tpu_torch.train.gan import Adam

    from benchmark.reference._plain import Adam as PlainAdam

    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(5, 3, generator=gen),
              "b": torch.randn(3, generator=gen)}
    prog_opt, plain = Adam(2e-4, b1=0.5), PlainAdam(params, 2e-4, 0.5)
    state, p_prog, p_plain = prog_opt.init(params), params, params
    for _ in range(2):
        grads = {k: torch.randn(v.shape, generator=gen)
                 for k, v in params.items()}
        upd, state = prog_opt.update(grads, state)
        p_prog = {k: p_prog[k] + upd[k] for k in params}
        p_plain = plain.step(p_plain, grads)
    for k in params:
        torch.testing.assert_close(p_prog[k], p_plain[k], rtol=0,
                                   atol=1e-7)
        torch.testing.assert_close(state.mu[k], plain.m[k], rtol=1e-6,
                                   atol=0)
