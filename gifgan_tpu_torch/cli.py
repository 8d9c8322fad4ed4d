"""Command line of the port: `python -m gifgan_tpu_torch <command>`.

The commands `train-dcgan`, `train-vid`, `train-recurrent`, `sample-wall`,
`quantize-export`, `track`, `invert`, `z-extract`, `make-paths`,
`derive-paths`, `visualize`, `export-web`, `combine-stats`, `scrape`,
`bulk-resize`, `video-to-gif`, `sample-frames`, `explorer`,
`webcam-serve`, `eval-fad`, `eval-track-rate`, `face-detect`,
`survey-serve`, `survey-pairs`, `bench`, `ckpt-downgrade` and
`ckpt-inspect` (all 27 of the JAX package's), with the flags of the JAX
package's (gifgan_tpu/cli.py), plus `--device` where a command touches
the card: it runs on the CUDA card unless `--device cpu` is given. One
command is the port's alone: `train-prednet`.

`--data-parallel`/`--fsdp`, and train-vid's `--tensor-parallel` and
`--seq-parallel`, run one process a rank, as torchrun starts them
(`torchrun --nproc-per-node N -m gifgan_tpu_torch train-vid
--data-parallel D --seq-parallel S --tensor-parallel M ...`, D*S*M = N):
`main` joins the process group first (parallel/distributed.py
initialize; inert in a single process).
`invert`, `z-extract` and `train-recurrent` write GIFs where the JAX
package writes mp4s; `invert`, `face-detect` and the image directories of
`train-dcgan` and `eval-fad` are read with cv2, as are the webcam
service's uploads.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _mesh_arg(args):
    """--data-parallel semantics: 0 = all ranks (no mesh when there is only
    one), 1 = explicitly no mesh, N>1 = N-way data parallel (the mesh must
    cover the world's ranks, as the JAX mesh its devices).
    --tensor-parallel / --seq-parallel (train-vid) add `model` / `seq` mesh
    axes; any value > 1 forces a mesh (the data axis takes the remaining
    ranks unless --data-parallel pins it)."""
    import torch.distributed as dist

    from gifgan_tpu_torch.core.mesh import make_mesh

    dp = getattr(args, "data_parallel", 0)
    tp = getattr(args, "tensor_parallel", 1) or 1
    sp = getattr(args, "seq_parallel", 1) or 1
    if tp <= 1 and sp <= 1:
        if dp == 1:
            return None
        world = dist.get_world_size() if dist.is_initialized() else 1
        if dp == 0 and world == 1:
            return None
    return make_mesh(data_parallel=dp, model_parallel=tp, seq_parallel=sp)


def _primary() -> bool:
    import torch.distributed as dist

    return not dist.is_initialized() or dist.get_rank() == 0


def _dcgan_cfg(args):
    from gifgan_tpu_torch.core.config import DCGANConfig

    return DCGANConfig(output_size=args.output_size, c_dim=args.c_dim,
                       z_dim=args.z_dim, gf_dim=args.gf_dim,
                       df_dim=args.df_dim, noise_std=args.image_noise,
                       compute_dtype=args.compute_dtype,
                       packed_c3=args.packed_c3)


def _train_cfg(args):
    from gifgan_tpu_torch.core.config import TrainConfig

    return TrainConfig(
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        d_learning_rate=args.d_learning_rate, beta1=args.beta1,
        disc_updates=args.disc_updates, gen_updates=args.gen_updates,
        epochs=args.epochs, sample_every=args.sample_every,
        checkpoint_every=args.checkpoint_every,
        max_checkpoints_to_keep=args.max_checkpoints_to_keep,
        train_img_gen=getattr(args, "train_img_gen", False),
        train_img_disc=getattr(args, "train_img_disc", False),
        seed=args.seed, run_dir=args.run_dir)


def _add_device_arg(p, what: str):
    p.add_argument("--device", default=None,
                   help=f"torch device of {what} (default: the CUDA card; "
                        f"cpu runs the kernels' plain versions)")


def _add_train_args(p, batch=64):
    p.add_argument("--batch-size", type=int, default=batch)
    p.add_argument("--learning-rate", type=float, default=2e-4)
    p.add_argument("--d-learning-rate", type=float, default=None,
                   help="TTUR: discriminator-specific LR (default: shared)")
    p.add_argument("--beta1", type=float, default=0.5)
    p.add_argument("--disc-updates", type=int, default=1)
    p.add_argument("--gen-updates", type=int, default=2)
    p.add_argument("--epochs", type=int, default=25)
    p.add_argument("--sample-every", type=int, default=100)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--max-checkpoints-to-keep", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--steps-limit", type=int, default=None)
    p.add_argument("--data-parallel", type=int, default=0,
                   help="ranks on the mesh data axis (0=all, 1=no mesh)")
    p.add_argument("--fsdp", action="store_true",
                   help="ZeRO-3: shard params + Adam slots over the data "
                        "axis (parallel/fsdp.py); needs a mesh")
    p.add_argument("--fsdp-min-size", type=int, default=2048,
                   help="leaves with fewer elements stay replicated")
    _add_device_arg(p, "the training run")


def _add_dcgan_args(p):
    p.add_argument("--output-size", type=int, default=64)
    p.add_argument("--c-dim", type=int, default=3)
    p.add_argument("--z-dim", type=int, default=100)
    p.add_argument("--gf-dim", type=int, default=64)
    p.add_argument("--df-dim", type=int, default=64)
    p.add_argument("--image-noise", type=float, default=0.0)
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--packed-c3", action="store_true",
                   help="phase-packed execution of the c-dim end layers "
                        "(D input conv space-to-depth, G output deconv "
                        "subpixel): the same function, another "
                        "accumulation order")


def _read_rgb(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB, read by cv2 (IMREAD_COLOR:
    alpha dropped, gray repeated to three channels)."""
    import cv2

    im = cv2.imread(path, cv2.IMREAD_COLOR)
    if im is None:
        raise SystemExit(f"cannot read image {path}")
    return cv2.cvtColor(im, cv2.COLOR_BGR2RGB)


def _stills_u8(args, cfg) -> np.ndarray:
    """(N, s, s, c) uint8 training stills: synthetic, or the png/jpg files
    of a directory (read with cv2 as RGB, gray repeated and alpha dropped,
    then the first c channels; resized with ops/image.py resize_bilinear
    where they are another size, rounded back to uint8)."""
    if args.dataset == "synthetic":
        from gifgan_tpu_torch.data.synthetic import synthetic_stills

        return synthetic_stills(args.dataset_size, size=cfg.output_size,
                                channels=cfg.c_dim)
    import torch

    from gifgan_tpu_torch.ops.image import resize_bilinear

    files = sorted(
        os.path.join(args.dataset, f) for f in os.listdir(args.dataset)
        if f.lower().endswith((".png", ".jpg", ".jpeg")))
    imgs = []
    for f in files:
        im = _read_rgb(f)[..., :cfg.c_dim]     # gray comes repeated
        if im.shape[:2] != (cfg.output_size,) * 2:
            im = resize_bilinear(torch.from_numpy(im), cfg.output_size,
                                 cfg.output_size).numpy()
        imgs.append(np.clip(np.rint(im), 0, 255).astype(np.uint8))
    return np.stack(imgs)


def _stills_source(args, cfg):
    """Host-iterator factory over the stills corpus ([-1, 1] float batches),
    shuffled by the epoch seed the loop passes."""
    from gifgan_tpu_torch.data.loader import batches_from_array

    data = _stills_u8(args, cfg).astype(np.float32) / 127.5 - 1.0
    return lambda epoch_seed=args.seed: batches_from_array(
        data, args.batch_size, shuffle=True, seed=epoch_seed)


def cmd_train_dcgan(args) -> None:
    from gifgan_tpu_torch.train import loops

    cfg = _dcgan_cfg(args)
    kw = dict(steps_limit=args.steps_limit, chunk=args.chunk,
              device=args.device, mesh=_mesh_arg(args), fsdp=args.fsdp,
              fsdp_min_size=args.fsdp_min_size)
    if args.device_corpus:
        loops.train_dcgan(None, cfg, _train_cfg(args),
                          stills_u8=_stills_u8(args, cfg), **kw)
        return
    loops.train_dcgan(_stills_source(args, cfg), cfg, _train_cfg(args), **kw)


def cmd_train_vid(args) -> None:
    from gifgan_tpu_torch.core.config import VidGANConfig
    from gifgan_tpu_torch.data.loader import batches_from_array
    from gifgan_tpu_torch.train import loops

    img_cfg = _dcgan_cfg(args)
    cfg = VidGANConfig(z_input_size=args.vid_z_dim,
                       z_output_size=args.z_dim,
                       vid_length=args.vid_length,
                       image_gan=img_cfg,
                       image_noise_std=args.image_noise,
                       activation_noise_std=args.activation_noise,
                       first_frame_loss_scalar=args.first_frame_loss_scalar)
    kw = dict(image_gan_ckpt=args.image_gan_checkpoint,
              steps_limit=args.steps_limit, chunk=args.chunk,
              auto_intervene=args.auto_intervene, device=args.device,
              mesh=_mesh_arg(args), fsdp=args.fsdp,
              fsdp_min_size=args.fsdp_min_size)

    def clips_u8():
        """The whole (N, T, s, s, c) uint8 clip corpus."""
        if args.dataset == "synthetic":
            from gifgan_tpu_torch.data.synthetic import synthetic_clips

            return synthetic_clips(args.dataset_size, length=cfg.vid_length,
                                   size=img_cfg.output_size,
                                   channels=img_cfg.c_dim)
        from gifgan_tpu_torch.data.video import decode_clip_batch

        files = sorted(os.path.join(args.dataset, f)
                       for f in os.listdir(args.dataset)
                       if f.endswith((".mp4", ".avi")))
        return decode_clip_batch(files, cfg.vid_length,
                                 img_cfg.output_size, strict=False)

    if args.device_corpus:
        if args.dataset != "synthetic" and args.stream:
            raise SystemExit("--device-corpus materializes the corpus on "
                             "the card; it is incompatible with --stream")
        loops.train_vid_dcgan(None, cfg, _train_cfg(args),
                              clips_u8=clips_u8(), **kw)
        return

    if args.dataset != "synthetic" and args.stream:
        # worker-pool decode; resize and normalize on the card (K2)
        from gifgan_tpu_torch.data.loader import clip_batches_from_files

        files = sorted(os.path.join(args.dataset, f)
                       for f in os.listdir(args.dataset)
                       if f.endswith((".mp4", ".avi", ".gif")))

        def clips_iter(epoch_seed=args.seed):
            yield from clip_batches_from_files(
                files, args.batch_size, cfg.vid_length,
                img_cfg.output_size, shuffle=True, seed=epoch_seed,
                workers=args.data_workers, device=args.device)
    else:
        clips = clips_u8().astype(np.float32) / 127.5 - 1.0

        def clips_iter(epoch_seed=args.seed):
            for batch in batches_from_array(clips, args.batch_size,
                                            shuffle=True, seed=epoch_seed):
                yield batch.reshape(-1, *batch.shape[2:])

    loops.train_vid_dcgan(clips_iter, cfg, _train_cfg(args), **kw)


def cmd_train_recurrent(args) -> None:
    """The JAX command's quirks are kept: it builds the config without
    --compute-dtype (float32 always), the host path's batch factory takes
    no epoch seed, so every epoch shuffles alike, and it accepts the mesh
    flags (--data-parallel, --fsdp, --fsdp-min-size) and ignores them."""
    from gifgan_tpu_torch.core.config import RecurrentImageConfig
    from gifgan_tpu_torch.data.loader import batches_from_array
    from gifgan_tpu_torch.train import loops

    cfg = RecurrentImageConfig(
        image_size=args.output_size, c_dim=args.c_dim,
        seq_length=args.vid_length, base_filters=args.gf_dim,
        lstm_units=args.lstm_units, num_lstm_layers=args.lstm_layers,
        lstm_dropout=args.lstm_dropout,
        share_disc_conv=args.share_disc_conv,
        pixel_loss_scalar=args.pixel_loss_scalar,
        residual_prediction=args.residual_prediction,
        adversarial_after_steps=args.adversarial_after_steps,
        adversarial_loss_scalar=args.adversarial_loss_scalar)

    if args.dataset == "synthetic":
        from gifgan_tpu_torch.data.synthetic import synthetic_clips

        clips = synthetic_clips(args.dataset_size,
                                length=cfg.seq_length + 1,
                                size=cfg.image_size, channels=cfg.c_dim)
    else:
        from gifgan_tpu_torch.data.video import decode_clip_batch

        files = sorted(os.path.join(args.dataset, f)
                       for f in os.listdir(args.dataset)
                       if f.endswith((".mp4", ".avi")))
        clips = decode_clip_batch(files, cfg.seq_length + 1,
                                  cfg.image_size, strict=False)
    kw = dict(resume=not args.no_resume, steps_limit=args.steps_limit,
              device=args.device)
    if args.device_corpus:
        loops.train_recurrent(None, cfg, _train_cfg(args), clips_u8=clips,
                              **kw)
        return
    clips = clips.astype(np.float32) / 255.0
    loops.train_recurrent(
        lambda: batches_from_array(clips, args.batch_size, shuffle=True,
                                   seed=args.seed),
        cfg, _train_cfg(args), **kw)


def cmd_train_prednet(args) -> None:
    """PredNet (models/prednet.py), one Adam update a batch; a command of
    the port alone. The defaults are the published KITTI run's
    (github.com/coxlab/prednet kitti_train.py); the JAX package's minimal
    model is `--stack-sizes 3 C0 --r-stack-sizes C0 C1 --lstm-gate sigmoid`.
    --dataset: "synthetic" (face-blob clips,
    cropped to the frame) or a .npy file of (N, nt, h, w, c) uint8 clips."""
    from gifgan_tpu_torch.core.config import TrainConfig
    from gifgan_tpu_torch.data.loader import batches_from_array
    from gifgan_tpu_torch.models.prednet import PredNetConfig
    from gifgan_tpu_torch.train import loops

    h, w = args.frame
    cfg = PredNetConfig(
        c_dim=args.stack_sizes[0], stack_sizes=tuple(args.stack_sizes),
        r_stack_sizes=tuple(args.r_stack_sizes), frame=(h, w),
        lstm_gate=args.lstm_gate, compute_dtype=args.compute_dtype)
    tcfg = TrainConfig(
        batch_size=args.batch_size, learning_rate=args.learning_rate,
        beta1=args.beta1, epochs=args.epochs, sample_every=args.sample_every,
        checkpoint_every=args.checkpoint_every,
        max_checkpoints_to_keep=args.max_checkpoints_to_keep,
        seed=args.seed, run_dir=args.run_dir)
    if args.dataset == "synthetic":
        from gifgan_tpu_torch.data.synthetic import synthetic_clips

        clips = synthetic_clips(args.dataset_size, length=args.nt,
                                size=max(h, w), channels=cfg.c_dim)
        clips = np.ascontiguousarray(clips[:, :, :h, :w])
    else:
        clips = np.load(args.dataset)
    kw = dict(resume=not args.no_resume, steps_limit=args.steps_limit,
              device=args.device)
    if args.device_corpus:
        loops.train_prednet(None, cfg, tcfg, clips_u8=clips, **kw)
        return
    clips = clips.astype(np.float32) / 255.0
    loops.train_prednet(
        lambda seed: batches_from_array(clips, args.batch_size, seed=seed),
        cfg, tcfg, **kw)


def _vid_sample_fn(args):
    """(cfg, sample_fn) from a train-vid run's checkpoints: float, or int8
    with --int8; or, with --quantized, from a quantize-export artifact (no
    float state loaded)."""
    from gifgan_tpu_torch.serve.sampler import vid_sample_fn, vid_sample_fn_q
    from gifgan_tpu_torch.train import vid

    mesh = _mesh_arg(args)
    if args.quantized:
        if args.int8 or args.int8_calib or args.int8_float_last:
            raise SystemExit(
                "--quantized loads a pre-quantized artifact; --int8/"
                "--int8-calib/--int8-float-last apply when quantizing from "
                "a float run — re-export with `quantize-export "
                "--calib-batches N [--float-last]` to change variants")
        from gifgan_tpu_torch.ops import quant

        q, cfg = quant.load_artifact(args.checkpoint, device=args.device)
        return cfg, vid_sample_fn_q(q, cfg, mesh)
    cfg, ts = vid.load_vid_train_state(args.checkpoint, device=args.device)
    if args.int8:
        q, _ = vid.quantize_sampler(ts, cfg, calib_batches=args.int8_calib,
                                    float_last=args.int8_float_last)
        return cfg, vid_sample_fn_q(q, cfg, mesh)
    return cfg, vid_sample_fn(ts, cfg, mesh)


def cmd_sample_wall(args) -> None:
    from gifgan_tpu_torch.serve.sampler import gif_wall

    cfg, sample_fn = _vid_sample_fn(args)
    n = gif_wall(sample_fn, cfg.z_input_size, args.out_dir,
                 batch_size=args.batch_size,
                 num_batches=None if args.continuous else args.num_batches,
                 continuous=args.continuous, fps=args.fps, seed=args.seed,
                 write=_primary())
    if _primary():
        print(f"wrote {n} gifs to {args.out_dir}")


def cmd_quantize_export(args) -> None:
    """Export an int8 serving artifact from a train-vid run (about 4x
    smaller than the float params; serve it with sample-wall
    --quantized)."""
    from gifgan_tpu_torch.ops import quant
    from gifgan_tpu_torch.train import vid

    cfg, ts = vid.load_vid_train_state(args.checkpoint, device=args.device)
    q, _ = vid.quantize_sampler(ts, cfg, calib_batches=args.calib_batches,
                                float_last=args.float_last,
                                calib_mode=args.calib_mode,
                                bias_correct=args.bias_correct)
    if args.finish_steps:
        q = quant.finish_vid_stack(q, ts.params, ts.state, cfg,
                                   steps=args.finish_steps)
    path = quant.save_artifact(args.out_dir, q, cfg)
    n_bytes = sum(os.path.getsize(os.path.join(root, f))
                  for root, _, fs in os.walk(args.out_dir) for f in fs)
    print(f"int8 artifact written to {path} ({n_bytes / 1e6:.1f} MB, "
          f"calib_batches={args.calib_batches} mode={args.calib_mode}, "
          f"bias_correct={args.bias_correct}, "
          f"finish_steps={args.finish_steps}, "
          f"float_last={args.float_last})")


def cmd_track(args) -> None:
    from gifgan_tpu_torch.core.config import TrackConfig
    from gifgan_tpu_torch.track.pipeline import run_directory

    cfg = TrackConfig(min_jaccard=args.min_jaccard, max_skip=args.max_skip,
                      min_frame_count=args.min_frame_count,
                      min_total_detections=args.min_total_detections,
                      target_size=args.target_size,
                      flow_backend=args.flow_backend,
                      detector_backend=args.detector_backend)
    stats = run_directory(args.input_directory, args.output_directory, cfg,
                          cascade_path=args.cascade,
                          max_consecutive_errors=args.max_consecutive_errors,
                          workers=args.workers,
                          detect_batch_clips=args.detect_batch,
                          device=args.device)
    print(stats.render_text())


def _load_dcgan_from_run(checkpoint_dir, device=None):
    """(cfg, params, state) from an image-GAN run's checkpoints dir, written
    by either package."""
    import torch

    from gifgan_tpu_torch import resolve_device
    from gifgan_tpu_torch.core import checkpoint as ckpt
    from gifgan_tpu_torch.core.config import load_config
    from gifgan_tpu_torch.train import gan

    device = resolve_device(device)
    doc = load_config(os.path.join(checkpoint_dir, os.pardir, "params.json"))
    cfg, tcfg = doc["model"], doc["train"]
    ts = gan.init_train_state(torch.Generator().manual_seed(0), cfg, tcfg,
                              device=device)
    ts = ckpt.restore(checkpoint_dir, ts)
    return cfg, ts.params, ts.state


def _read_image(path: str, cfg) -> np.ndarray:
    """An image file -> (s, s, c) float32 in [-1, 1]: read by cv2 (BGR,
    alpha dropped) and turned to RGB, its first c_dim channels, resized
    where it is another size by ops/image.py resize_bilinear (the JAX
    package's jax.image.resize "linear") and clipped to [0, 255]."""
    import torch

    from gifgan_tpu_torch.ops.image import resize_bilinear

    im = _read_rgb(path)[..., :cfg.c_dim]
    if im.shape[:2] != (cfg.output_size,) * 2:
        im = np.clip(resize_bilinear(torch.from_numpy(im), cfg.output_size,
                                     cfg.output_size).numpy(), 0, 255)
    return im.astype(np.float32) / 127.5 - 1.0


def cmd_invert(args) -> None:
    """Image inversion + expression-path animation (the reference's
    discriminator_activation_optimizer workflow)."""
    from gifgan_tpu_torch.core.config import InvertConfig
    from gifgan_tpu_torch.data.video import write_gif
    from gifgan_tpu_torch.invert import apply_latent_path, invert_images
    from gifgan_tpu_torch.ops.image import denorm_u8, write_png
    from gifgan_tpu_torch.serve.explorer import parse_z_text

    cfg, params, state = _load_dcgan_from_run(args.checkpoint, args.device)
    targets = [_read_image(p, cfg) for p in args.input_images]
    reps = max(1, args.batch_size // max(1, len(targets)))
    batch = np.stack((targets * reps)[:args.batch_size])

    icfg = InvertConfig(steps=args.num_steps, learning_rate=args.learning_rate,
                        lr_decay_every=args.lr_decay_frequency or 10**9,
                        lr_decay_factor=args.lr_decay_amount,
                        pixel_l1=args.pixel_l1_weight,
                        pixel_l2=args.pixel_l2_weight,
                        activation_l1=args.activations_l1_weight,
                        activation_l2=args.activations_l2_weight,
                        generator_loss=args.generator_loss_weight,
                        use_train_mode_activations=(
                            args.discriminator_mode == "train"),
                        batch_size=len(batch))
    os.makedirs(args.sample_dir, exist_ok=True)
    sections = ([tuple(int(v) for v in s.split(","))
                 for s in args.progress_vid_sections]
                if args.progress_vid_sections else None)
    z, losses, frames = invert_images(params, state, batch, cfg, icfg,
                                      progress_sections=sections,
                                      device=args.device)
    np.save(os.path.join(args.sample_dir, "z.npy"), z.cpu().numpy())
    if frames:
        write_png(os.path.join(args.sample_dir, "final.png"),
                  denorm_u8(frames[-1][0]))
    print(f"final loss: {losses[-1]:.6f}")

    for i, p in enumerate(args.input_paths):
        if p.endswith(".npy"):
            path_zs = np.load(p)
        else:
            with open(p) as f:
                path_zs = parse_z_text(f.read())
        vid = apply_latent_path(params, state, z[:1], path_zs, cfg,
                                device=args.device)[:, 0]
        write_gif(os.path.join(args.sample_dir, f"path_{i:02d}.gif"),
                  denorm_u8(vid))
    print("wrote", args.sample_dir)


def cmd_z_extract(args) -> None:
    """Batch dataset z-trajectory extraction (the reference's
    z_space_finder)."""
    from gifgan_tpu_torch.core.config import InvertConfig
    from gifgan_tpu_torch.data.video import decode_clip
    from gifgan_tpu_torch.invert.z_finder import extract_z_trajectories

    cfg, params, state = _load_dcgan_from_run(args.checkpoint, args.device)
    icfg = InvertConfig(steps=args.num_initial_steps,
                        learning_rate=args.learning_rate,
                        pixel_l1=args.pixel_l1_weight,
                        activation_l1=args.activations_l1_weight,
                        batch_size=args.batch_size)
    files = sorted(os.path.join(args.input_directory, f)
                   for f in os.listdir(args.input_directory)
                   if f.endswith((".mp4", ".avi", ".gif")))

    def load_clip(path):
        try:
            clip = decode_clip(path, args.vid_length, cfg.output_size,
                               strict=False)
        except Exception:      # undecodable: the finder skips it
            return None
        return clip.astype(np.float32) / 127.5 - 1.0

    written = extract_z_trajectories(
        params, state, cfg, icfg, files, load_clip, args.output_z_folder,
        batch_size=args.batch_size,
        num_initial_steps=args.num_initial_steps,
        num_steps_per_frame=args.num_steps_per_frame,
        stop_after=args.stop_after,
        write_comparisons=args.write_comparisons, device=args.device)
    print(f"wrote {len(written)} trajectories")


def cmd_make_paths(args) -> None:
    """The named expression-path library, generated procedurally."""
    from gifgan_tpu_torch.demo import make_expression_paths, write_paths

    paths = make_expression_paths(args.z_dim, frames=args.frames,
                                  magnitude=args.magnitude, seed=args.seed)
    write_paths(args.out_dir, paths)
    print(f"wrote {len(paths)} expression paths to {args.out_dir}: "
          f"{', '.join(sorted(paths))}")


def cmd_derive_paths(args) -> None:
    """Data-derived expression paths from z-extract trajectories."""
    from gifgan_tpu_torch.demo import (derive_paths, load_trajectories,
                                       make_expression_paths,
                                       pca_directions, write_paths)

    trajs = load_trajectories(args.traj_dir)
    if not trajs:
        raise SystemExit(f"no (T, z_dim) .npy trajectories in "
                         f"{args.traj_dir}")
    paths = derive_paths(trajs, top_k=args.top_k,
                         smooth_window=args.smooth_window,
                         magnitude=args.magnitude,
                         jerk_weight=args.jerk_weight)
    if args.pca:
        dirs = pca_directions(trajs, n_directions=max(args.pca, 7))
        if dirs.shape[0] < 7:   # EXPRESSIONS indexes directions 0..6
            print(f"warning: only {dirs.shape[0]} PCA directions available "
                  f"(< 7 needed for the named expression set) — skipping "
                  f"the pca_* paths")
        else:
            frames = next(iter(trajs.values())).shape[0]
            for name, p_arr in make_expression_paths(
                    dirs.shape[1], frames=frames,
                    directions=dirs).items():
                paths[f"pca_{name}"] = p_arr
    write_paths(args.out_dir, paths)
    print(f"derived {len(paths)} paths from {len(trajs)} trajectories "
          f"-> {args.out_dir}: {', '.join(sorted(paths))}")


def cmd_visualize(args) -> None:
    """Per-dimension z-sweep grids (the reference's visualize modes 0-4)."""
    import torch

    from gifgan_tpu_torch import resolve_device
    from gifgan_tpu_torch.eval.visualize import visualize
    from gifgan_tpu_torch.models import dcgan

    device = resolve_device(args.device)
    cfg, params, state = _load_dcgan_from_run(args.checkpoint, device)

    def sample_fn(z):
        return dcgan.sample(params, state, torch.as_tensor(z, device=device),
                            cfg)

    paths = visualize(sample_fn, cfg.z_dim, args.batch_size, args.option,
                      args.out_dir, num_dims=args.num_dims, seed=args.seed)
    print(f"wrote {len(paths)} files to {args.out_dir}")


def cmd_combine_stats(args) -> None:
    from gifgan_tpu_torch.track.stats import combine_stats_files

    combined = combine_stats_files(args.stats_files)
    combined.write(args.out_dir)
    print(combined.render_text())


def cmd_scrape(args) -> None:
    """Keyword GIF scraper; --dry-run validates the keyword file and the
    output tree and prints the work plan without touching the network."""
    import json

    from gifgan_tpu_torch.data.scrape import (Scraper, default_fetch,
                                              parse_keywords, scan_existing)

    with open(args.keywords) as f:
        keywords = parse_keywords(f.read())
    if args.dry_run:
        existing = scan_existing(args.out_dir)
        os.makedirs(args.out_dir, exist_ok=True)
        print(json.dumps({
            "dry_run": True,
            "keywords": keywords,
            "already_downloaded_ids": len(existing),
            "threads_per_keyword": args.num_threads,
            "items_per_thread": args.items_per_thread,
            "planned_requests_per_keyword":
                args.num_threads * -(-args.items_per_thread // 100),
        }))
        return
    s = Scraper(args.out_dir, default_fetch, api_key=args.api_key,
                num_threads=args.num_threads,
                items_per_thread=args.items_per_thread)
    stats = s.scrape(keywords)
    print(json.dumps({"new_total": stats.new_total,
                      "per_keyword": stats.per_keyword,
                      "errors": stats.errors}))


def cmd_bulk_resize(args) -> None:
    import json

    from gifgan_tpu_torch.data.video import bulk_resize

    print(json.dumps(bulk_resize(args.input_directory, args.output_directory,
                                 args.width, args.length)))


def cmd_video_to_gif(args) -> None:
    from gifgan_tpu_torch.data.video import video_to_gif

    os.makedirs(args.output_directory, exist_ok=True)
    for name in sorted(os.listdir(args.input_directory)):
        if name.endswith((".avi", ".mp4")):
            out = os.path.join(args.output_directory,
                               os.path.splitext(name)[0] + ".gif")
            video_to_gif(os.path.join(args.input_directory, name), out,
                         fps=args.fps)
            print("wrote", out)


def cmd_sample_frames(args) -> None:
    """Training stills sampled from videos; a GIF's frames are resized on
    the card (K2), an mp4's or avi's by cv2."""
    from gifgan_tpu_torch import resolve_device
    from gifgan_tpu_torch.data.video import sample_frames_from_video
    from gifgan_tpu_torch.ops.image import write_png

    device = resolve_device(args.device)
    os.makedirs(args.output_directory, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    count = 0
    for name in sorted(os.listdir(args.input_directory)):
        if not name.endswith((".mp4", ".avi", ".gif")):
            continue
        frames = sample_frames_from_video(
            os.path.join(args.input_directory, name),
            args.frames_per_video, args.size, rng, device=device)
        for f in frames:
            write_png(os.path.join(args.output_directory,
                                   f"{count:07d}.png"), f)
            count += 1
    print(f"wrote {count} frames")


def _image_dir_to_batch(d: str, size: int, c_dim: int) -> np.ndarray:
    """Directory of pngs/jpgs -> (N, size, size, c) float images in [-1, 1]
    (read and resized as _stills_u8 does)."""
    import types

    args = types.SimpleNamespace(dataset=d, dataset_size=0)
    cfg = types.SimpleNamespace(output_size=size, c_dim=c_dim)
    return _stills_u8(args, cfg).astype(np.float32) / 127.5 - 1.0


def cmd_eval_fad(args) -> None:
    """Fréchet Activation Distance between two image sets under a trained
    image-D's h2 embedding (eval/fad.py), features extracted on the card."""
    import json

    from gifgan_tpu_torch import resolve_device
    from gifgan_tpu_torch.eval.fad import fad

    device = resolve_device(args.device)
    cfg, params, state = _load_dcgan_from_run(args.checkpoint, device)
    real = _image_dir_to_batch(args.real_dir, cfg.output_size, cfg.c_dim)
    fake = _image_dir_to_batch(args.fake_dir, cfg.output_size, cfg.c_dim)
    d = fad(params["discriminator"], state["discriminator"], real, fake,
            cfg, batch=args.batch_size, device=device)
    print(json.dumps({"fad": round(d, 6), "n_real": len(real),
                      "n_fake": len(fake)}))


def cmd_eval_track_rate(args) -> None:
    """The face-track-rate metric over sample directories: the cascade on
    the card (the device detector, one dispatch a clip, K3) and the
    stabilizer's device flow (K4)."""
    from gifgan_tpu_torch import resolve_device
    from gifgan_tpu_torch.data.video import read_gif
    from gifgan_tpu_torch.eval import face_track_rate, track_rate_report
    from gifgan_tpu_torch.eval.track_rate import EVAL_TRACK_CONFIG
    from gifgan_tpu_torch.track.detect import default_detector

    device = resolve_device(args.device)
    detector = default_detector(cascade_path=args.cascade, min_neighbors=2,
                                min_size=20, device=device)
    results = {}
    for d in args.sample_dirs:
        clips = []
        for f in sorted(os.listdir(d))[:args.limit]:
            if f.endswith(".gif"):
                clip = read_gif(os.path.join(d, f))
                if args.upscale != 1:
                    clip = np.repeat(np.repeat(clip, args.upscale, 1),
                                     args.upscale, 2)
                clips.append(clip)
        results[os.path.basename(d.rstrip("/"))] = face_track_rate(
            clips, detector, EVAL_TRACK_CONFIG, device=device)
    print(track_rate_report(results, out_dir=args.out_dir))


def cmd_face_detect(args) -> None:
    """Single-image face detection with best-face ranking and MSSIM search
    (the facedetect.py tool: --best / --biggest / --query): the cascade on
    the card (K3); crops resized to 64x64 by ops/image.py resize_bilinear
    (antialiased, as jax.image.resize "linear")."""
    import json

    import torch

    from gifgan_tpu_torch import resolve_device
    from gifgan_tpu_torch.ops.image import resize_bilinear
    from gifgan_tpu_torch.track.detect import (default_detector, mssim,
                                               rank_faces)

    device = resolve_device(args.device)
    detector = default_detector(cascade_path=args.cascade, min_neighbors=3,
                                min_size=args.min_size, device=device)
    frame = _read_rgb(args.image)
    dets = detector(frame, 0)
    if not dets:
        print(json.dumps({"faces": []}))
        return
    boxes = np.array([[d.x1, d.y1, d.x2, d.y2] for d in dets])
    crops = torch.stack([
        resize_bilinear(torch.as_tensor(
            frame[d.y1:d.y2 + 1, d.x1:d.x2 + 1]).to(device), 64, 64)
        for d in dets])
    out = {"faces": boxes.tolist()}
    if args.best:
        scores = rank_faces(crops, boxes, frame.shape)
        out["best"] = boxes[int(np.argmax(scores))].tolist()
        out["scores"] = [float(s) for s in scores]
    if args.biggest:
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        out["biggest"] = boxes[int(np.argmax(areas))].tolist()
    if args.query:
        q64 = resize_bilinear(torch.as_tensor(_read_rgb(args.query)).to(
            device), 64, 64)
        sims = mssim(q64[None].expand_as(crops), crops).cpu().numpy()
        out["most_similar"] = boxes[int(np.argmax(sims))].tolist()
        out["similarities"] = [float(s) for s in sims]
    print(json.dumps(out))


def cmd_survey_pairs(args) -> None:
    from gifgan_tpu_torch.eval.survey import make_pair_manifest

    out = make_pair_manifest(args.sample_dir, args.variant_a, args.variant_b,
                             n=args.n, seed=args.seed,
                             url_prefix=args.url_prefix)
    print(f"{len(out['pairs'])} pairs ({args.variant_a} vs {args.variant_b})"
          f" -> {os.path.join(args.sample_dir, 'pairs.json')} + pairs.csv")


def cmd_bench(args) -> None:
    """The flagship train-step benchmark (bench.py): one JSON line."""
    from gifgan_tpu_torch import bench

    bench.main([] if args.device is None else ["--device", args.device])


def cmd_export_web(args) -> None:
    """Export the image generator as a self-contained browser demo dir
    (weights.json + golden fixture + draw.html/generator.js — the
    reference's web/ convnet.js demo, serve/web_export.py)."""
    from gifgan_tpu_torch.serve.web_export import export_browser_demo

    cfg, params, state = _load_dcgan_from_run(args.checkpoint, args.device)
    out = export_browser_demo(params["generator"], state["generator"], cfg,
                              args.out_dir)
    print(f"browser demo exported to {out}; serve it and open draw.html "
          "(?selftest=1 runs the pixel-parity check)")


def cmd_ckpt_downgrade(args) -> None:
    from gifgan_tpu_torch.core.ckpt_tools import downgrade_checkpoint

    out = downgrade_checkpoint(args.input_prefix, args.output)
    print(f"wrote V1 TensorSlice checkpoint: {out}")


def cmd_ckpt_inspect(args) -> None:
    if os.path.isdir(args.path):
        from gifgan_tpu_torch.core.ckpt_tools import inspect

        print(inspect(args.path))
    else:
        from gifgan_tpu_torch.core.ckpt_tools import read_tf_checkpoint

        for name, arr in sorted(read_tf_checkpoint(args.path).items()):
            print(f"{name}  {arr.dtype}  {arr.shape}")


def cmd_explorer(args) -> None:
    """The latent explorer web app on a train-dcgan run's generator, float
    or int8, on the card (resolved before the server listens)."""
    import time

    from gifgan_tpu_torch.serve import STATIC_DIR
    from gifgan_tpu_torch.serve.explorer import (ExplorerCore, dcgan_sampler,
                                                 serve)

    cfg, params, state = _load_dcgan_from_run(args.checkpoint, args.device)
    sampler = dcgan_sampler(params, state, cfg, batch_size=args.batch_size,
                            int8=args.int8, int8_calib=args.int8_calib,
                            int8_float_last=args.int8_float_last,
                            device=args.device)
    core = ExplorerCore(sampler, cfg.z_dim, args.media_dir,
                        batch_size=args.batch_size)
    if args.warmup:
        t0 = time.perf_counter()
        sampler(np.zeros((args.batch_size, cfg.z_dim), np.float32))
        print(f"sampler warm ({time.perf_counter() - t0:.1f}s)")
    print(f"explorer listening on {args.host}:{args.port}")
    serve(core, host=args.host, port=args.port, static_dir=STATIC_DIR,
          auth_token=args.auth_token,
          tls_cert=args.tls_cert, tls_key=args.tls_key)


def cmd_webcam_serve(args) -> None:
    """The webcam demo's inversion service on a train-dcgan run, on the
    card (resolved before the server listens)."""
    import time

    from gifgan_tpu_torch.serve.webcam import (WebcamBackend,
                                               load_latent_paths, serve)

    cfg, params, state = _load_dcgan_from_run(args.checkpoint, args.device)
    paths = (load_latent_paths(args.paths_dir, cfg.z_dim)
             if args.paths_dir else {})
    backend = WebcamBackend(params, state, cfg, args.out_dir, paths=paths,
                            steps=args.num_steps,
                            batch_size=args.batch_size, device=args.device)
    if args.warmup:
        t0 = time.perf_counter()
        backend.warmup()
        print(f"inversion warm ({time.perf_counter() - t0:.1f}s)")
    print(f"webcam service on {args.host}:{args.port} "
          f"({len(paths)} expression paths)")
    serve(backend, host=args.host, port=args.port,
          auth_token=args.auth_token,
          tls_cert=args.tls_cert, tls_key=args.tls_key)


def cmd_survey_serve(args) -> None:
    from gifgan_tpu_torch.serve.survey import SurveyServer, serve

    survey = SurveyServer(args.sample_dir)
    print(f"survey on {args.host}:{args.port} "
          f"(responses -> {survey.responses_path})")
    serve(survey, host=args.host, port=args.port,
          tls_cert=args.tls_cert, tls_key=args.tls_key)


def _add_tls_args(p):
    p.add_argument("--tls-cert", default=None,
                   help="PEM certificate chain: serve HTTPS in-process "
                        "(terminating TLS at a front proxy works too — "
                        "see serve/http_common.py)")
    p.add_argument("--tls-key", default=None,
                   help="PEM private key for --tls-cert")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="gifgan_tpu_torch")
    sub = ap.add_subparsers(dest="command", required=True)

    p = sub.add_parser("train-dcgan", help="train the image DCGAN")
    p.add_argument("--chunk", type=int, default=1,
                   help="batches per train_chunk call")
    p.add_argument("--device-corpus", action="store_true",
                   help="upload the uint8 corpus to the card once and "
                        "gather each batch there (K1); the host ships ids")
    _add_dcgan_args(p)
    _add_train_args(p)
    p.add_argument("--dataset", default="synthetic",
                   help="'synthetic' or a directory of images")
    p.add_argument("--dataset-size", type=int, default=512)
    p.set_defaults(fn=cmd_train_dcgan)

    p = sub.add_parser("train-vid", help="train the recurrent-z video GAN")
    _add_dcgan_args(p)
    _add_train_args(p)
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--dataset-size", type=int, default=256)
    p.add_argument("--vid-z-dim", type=int, default=120)
    p.add_argument("--vid-length", type=int, default=16)
    p.add_argument("--activation-noise", type=float, default=0.0)
    p.add_argument("--first-frame-loss-scalar", type=float, default=0.0)
    p.add_argument("--image-gan-checkpoint", default=None,
                   help="a train-dcgan run's checkpoints dir, grafted into "
                        "the frozen image nets")
    p.add_argument("--chunk", type=int, default=1,
                   help="batches per train_chunk call")
    p.add_argument("--stream", action="store_true",
                   help="stream-decode clips from the --dataset dir on "
                        "worker threads, resized on the card (K2), instead "
                        "of loading all in memory")
    p.add_argument("--data-workers", type=int, default=4,
                   help="decode worker threads for --stream")
    p.add_argument("--device-corpus", action="store_true",
                   help="upload the uint8 clip corpus to the card once and "
                        "gather each batch there (K1); incompatible with "
                        "--stream")
    p.add_argument("--train-img-gen", action="store_true")
    p.add_argument("--train-img-disc", action="store_true")
    p.add_argument("--auto-intervene", action="store_true",
                   help="closed-loop collapse controller "
                        "(train/controller.py): per-chunk d_loss drives the "
                        "noise and D-lr knobs")
    p.add_argument("--tensor-parallel", type=int, default=1,
                   help="ranks on the mesh `model` axis: conv/linear "
                        "weights AND Adam slots channel-sharded "
                        "(parallel/tp.py full layout). Composes with "
                        "--data-parallel/--seq-parallel; not with --fsdp")
    p.add_argument("--seq-parallel", type=int, default=1,
                   help="ranks on the mesh `seq` axis: the time dimension "
                        "WITHIN each clip shards over ranks "
                        "(parallel/sp.py) — reaches the few-long-clips "
                        "regime plain DP cannot. Composes with "
                        "--data-parallel/--tensor-parallel/"
                        "--auto-intervene")
    p.set_defaults(fn=cmd_train_vid)

    p = sub.add_parser("train-recurrent",
                       help="train the frame-conditioned recurrent GAN")
    _add_dcgan_args(p)
    _add_train_args(p, batch=40)
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--dataset-size", type=int, default=256)
    p.add_argument("--vid-length", type=int, default=16)
    p.add_argument("--lstm-units", type=int, default=100)
    p.add_argument("--lstm-layers", type=int, default=1)
    p.add_argument("--lstm-dropout", type=float, default=0.0)
    p.add_argument("--share-disc-conv", action="store_true")
    p.add_argument("--pixel-loss-scalar", type=float, default=0.0,
                   help="L1 next-frame term added to the adversarial G loss "
                        "(deviation from the reference; 0 = reference loss)")
    p.add_argument("--residual-prediction", action="store_true",
                   help="predict the frame delta (deviation; see config)")
    p.add_argument("--adversarial-after-steps", type=int, default=0,
                   help="pixel-only G warm-up until this step (deviation)")
    p.add_argument("--adversarial-loss-scalar", type=float, default=1.0,
                   help="weight on G's adversarial term once active "
                        "(deviation; the reference hard-codes 1.0)")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--device-corpus", action="store_true",
                   help="upload the uint8 clip corpus to the card once and "
                        "sample each batch there in [0, 1] (the take "
                        "gather: K1 bakes [-1, 1]); the host ships ids")
    p.set_defaults(fn=cmd_train_recurrent)

    p = sub.add_parser("train-prednet",
                       help="train PredNet (next-frame prediction)")
    p.add_argument("--stack-sizes", type=int, nargs="+",
                   default=[3, 48, 96, 192],
                   help="A and A_hat channels a level; the first is the "
                        "frame's")
    p.add_argument("--r-stack-sizes", type=int, nargs="+",
                   default=[3, 48, 96, 192], help="R channels a level")
    p.add_argument("--frame", type=int, nargs=2, default=[128, 160],
                   metavar=("H", "W"))
    p.add_argument("--nt", type=int, default=10,
                   help="frames a synthetic clip (a .npy dataset brings its "
                        "own)")
    p.add_argument("--lstm-gate", default="hard_sigmoid",
                   choices=["hard_sigmoid", "sigmoid"],
                   help="hard_sigmoid, no forget bias, glorot_uniform "
                        "weights (published); sigmoid with +1 on the forget "
                        "gate, normal 0.05 weights (the JAX package's)")
    p.add_argument("--compute-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="the convolutions' dtype; gates, state and errors "
                        "stay float32")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--beta1", type=float, default=0.9)
    p.add_argument("--epochs", type=int, default=150)
    p.add_argument("--sample-every", type=int, default=100)
    p.add_argument("--checkpoint-every", type=int, default=500)
    p.add_argument("--max-checkpoints-to-keep", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--run-dir", required=True)
    p.add_argument("--steps-limit", type=int, default=None)
    p.add_argument("--dataset", default="synthetic",
                   help="'synthetic' or a .npy of (N, nt, h, w, c) uint8 "
                        "clips")
    p.add_argument("--dataset-size", type=int, default=256)
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--device-corpus", action="store_true",
                   help="upload the uint8 clip corpus to the card once and "
                        "sample each batch there in [0, 1]; the host ships "
                        "ids")
    _add_device_arg(p, "the training run")
    p.set_defaults(fn=cmd_train_prednet)

    p = sub.add_parser("sample-wall", help="continuous GIF sampler")
    p.add_argument("--checkpoint", required=True,
                   help="run_dir/checkpoints of a train-vid run")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-batches", type=int, default=1)
    p.add_argument("--continuous", action="store_true")
    p.add_argument("--fps", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--int8", action="store_true",
                   help="serve the int8-quantized generator stack "
                        "(ops/quant.py: int8 tensor-core products)")
    p.add_argument("--int8-calib", type=int, default=0,
                   help="with --int8: bake static activation scales from "
                        "N calibration batches (skips the per-layer "
                        "dynamic max reduce; inputs beyond the calibrated "
                        "range clip)")
    p.add_argument("--int8-float-last", action="store_true",
                   help="with --int8: keep the tanh output layer in "
                        "float32 (mixed precision)")
    p.add_argument("--quantized", action="store_true",
                   help="--checkpoint points at a quantize-export int8 "
                        "artifact instead of a train run")
    p.add_argument("--data-parallel", type=int, default=1,
                   help="shard the sampler batch over the mesh data axis "
                        "(0=all ranks, 1=single device [default]; N>1 "
                        "must equal the world size, like the train "
                        "commands); N must divide --batch-size")
    _add_device_arg(p, "the sampler")
    p.set_defaults(fn=cmd_sample_wall)

    p = sub.add_parser("quantize-export",
                       help="export an int8 serving artifact from a "
                            "trained vid run")
    p.add_argument("--checkpoint", required=True,
                   help="run_dir/checkpoints of a train-vid run")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--calib-batches", type=int, default=0,
                   help="bake static activation scales from N batches")
    p.add_argument("--calib-mode", default="max", choices=["max", "mse"],
                   help="static-scale calibration: max-abs or the argmin-"
                        "MSE fraction sweep")
    p.add_argument("--bias-correct", action="store_true",
                   help="per-layer empirical bias correction against the "
                        "float folded reference")
    p.add_argument("--finish-steps", type=int, default=0,
                   help="fake-quant/STE finishing steps before export")
    p.add_argument("--float-last", action="store_true",
                   help="keep the tanh output layer in float32 (mixed "
                        "precision; see sample-wall --int8-float-last)")
    _add_device_arg(p, "the export")
    p.set_defaults(fn=cmd_quantize_export)

    p = sub.add_parser("track", help="face-track preprocessing over a dir")
    p.add_argument("--input-directory", required=True)
    p.add_argument("--output-directory", required=True)
    p.add_argument("--min-jaccard", type=float, default=0.60)
    p.add_argument("--max-skip", type=int, default=6)
    p.add_argument("--min-frame-count", type=int, default=20)
    p.add_argument("--min-total-detections", type=int, default=10)
    p.add_argument("--target-size", type=int, default=256)
    p.add_argument("--max-consecutive-errors", type=int, default=10)
    p.add_argument("--cascade", default=None,
                   help="path to an OpenCV Haar cascade XML")
    p.add_argument("--flow-backend", default="auto",
                   choices=["auto", "cv2", "mxu", "jax"],
                   help="stabilizer corner+LK backend (auto and mxu = the "
                        "device kernels, kernels/flow.py; cv2 = OpenCV on "
                        "the host; jax = the gather flow, "
                        "track/flow_gather.py, on the device)")
    p.add_argument("--detector-backend", default="auto",
                   choices=["auto", "native", "device", "cv2", "python"],
                   help="Haar cascade backend (auto and device = the "
                        "pyramid-packed cascade on the card, "
                        "track/haar_device.py; the others run on the host)")
    p.add_argument("--workers", type=int, default=1,
                   help="thread-pool file concurrency (decode releases the "
                        "GIL)")
    p.add_argument("--detect-batch", type=int, default=1,
                   help="with the device detector: decode N files per group "
                        "and detect them in one dispatch (detect_clips)")
    _add_device_arg(p, "the device kernels")
    p.set_defaults(fn=cmd_track)

    p = sub.add_parser("invert", help="GAN inversion + path animation")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input-images", nargs="+", required=True)
    p.add_argument("--input-paths", nargs="*", default=[])
    p.add_argument("--sample-dir", required=True)
    p.add_argument("--num-steps", type=int, default=1000)
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--lr-decay-frequency", type=int, default=0)
    p.add_argument("--lr-decay-amount", type=float, default=0.9)
    p.add_argument("--discriminator-mode", default="inference",
                   choices=["train", "inference"])
    p.add_argument("--pixel-l1-weight", type=float, default=0.0)
    p.add_argument("--pixel-l2-weight", type=float, default=0.0)
    p.add_argument("--activations-l1-weight", type=float, default=0.0)
    p.add_argument("--activations-l2-weight", type=float, default=1.0)
    p.add_argument("--generator-loss-weight", type=float, default=0.0)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--progress-vid-sections", nargs="*", default=[])
    _add_device_arg(p, "the inversion")
    p.set_defaults(fn=cmd_invert)

    p = sub.add_parser("z-extract", help="dataset -> z trajectories")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--input-directory", required=True)
    p.add_argument("--output-z-folder", required=True)
    p.add_argument("--vid-length", type=int, default=16)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--num-initial-steps", type=int, default=500)
    p.add_argument("--num-steps-per-frame", type=int, default=100)
    p.add_argument("--learning-rate", type=float, default=0.05)
    p.add_argument("--pixel-l1-weight", type=float, default=1.0)
    p.add_argument("--activations-l1-weight", type=float, default=0.3)
    p.add_argument("--stop-after", type=int, default=None)
    p.add_argument("--write-comparisons", action="store_true")
    _add_device_arg(p, "the inversion")
    p.set_defaults(fn=cmd_z_extract)

    p = sub.add_parser("make-paths", help="generate expression-path library")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--z-dim", type=int, default=100)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--magnitude", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_make_paths)

    p = sub.add_parser(
        "derive-paths",
        help="derive expression paths from extracted z-trajectories")
    p.add_argument("--traj-dir", required=True,
                   help="z-extract output dir of per-clip (T, z_dim) .npy")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--top-k", type=int, default=4)
    p.add_argument("--smooth-window", type=int, default=3)
    p.add_argument("--magnitude", type=float, default=0.0,
                   help="rescale so the peak frame-delta norm equals this "
                        "(0 = keep the empirical scale)")
    p.add_argument("--jerk-weight", type=float, default=2.0)
    p.add_argument("--pca", type=int, default=0,
                   help="additionally emit the procedural expression set "
                        "riding the top-N PCA motion directions")
    p.set_defaults(fn=cmd_derive_paths)

    p = sub.add_parser("visualize", help="z-sweep sample grids (5 modes)")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--option", type=int, default=1, choices=[0, 1, 2, 3, 4])
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--num-dims", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    _add_device_arg(p, "the sampler")
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("export-web", help="export browser draw-your-own-z demo")
    p.add_argument("--checkpoint", required=True,
                   help="run_dir/checkpoints of a train-dcgan run")
    p.add_argument("--out-dir", required=True)
    _add_device_arg(p, "the golden image")
    p.set_defaults(fn=cmd_export_web)

    p = sub.add_parser("combine-stats", help="merge sharded track stats")
    p.add_argument("stats_files", nargs="+")
    p.add_argument("--out-dir", required=True)
    p.set_defaults(fn=cmd_combine_stats)

    p = sub.add_parser("scrape", help="keyword GIF scraper")
    p.add_argument("--keywords", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--api-key", default="")
    p.add_argument("--num-threads", type=int, default=8)
    p.add_argument("--items-per-thread", type=int, default=200)
    p.add_argument("--dry-run", action="store_true",
                   help="no network: validate the keyword file and print "
                        "the work plan as JSON")
    p.set_defaults(fn=cmd_scrape)

    p = sub.add_parser("bulk-resize")
    p.add_argument("--input-directory", required=True)
    p.add_argument("--output-directory", required=True)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--length", type=int, default=16)
    p.set_defaults(fn=cmd_bulk_resize)

    p = sub.add_parser("video-to-gif")
    p.add_argument("--input-directory", required=True)
    p.add_argument("--output-directory", required=True)
    p.add_argument("--fps", type=float, default=8.0)
    p.set_defaults(fn=cmd_video_to_gif)

    p = sub.add_parser("sample-frames",
                       help="sample training stills from videos")
    p.add_argument("--input-directory", required=True)
    p.add_argument("--output-directory", required=True)
    p.add_argument("--frames-per-video", type=int, default=5)
    p.add_argument("--size", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    _add_device_arg(p, "the GIF frames' resize (K2)")
    p.set_defaults(fn=cmd_sample_frames)

    p = sub.add_parser("explorer", help="latent explorer web app")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--media-dir", default="/tmp/gifgan_explorer")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--auth-token", default=None,
                   help="require Authorization: Bearer <token>. ?token= is "
                        "also accepted for browser convenience, but URLs "
                        "with embedded secrets leak via history/referrers/"
                        "proxy logs — prefer the header off-localhost")
    p.add_argument("--warmup", action="store_true",
                   help="run the sampler once before serving")
    p.add_argument("--int8", action="store_true",
                   help="serve the int8-quantized generator (ops/quant.py: "
                        "int8 tensor-core products)")
    p.add_argument("--int8-calib", type=int, default=0,
                   help="with --int8: static activation scales from N "
                        "calibration batches")
    p.add_argument("--int8-float-last", action="store_true",
                   help="with --int8: keep the tanh output layer in f32 "
                        "(mixed precision)")
    _add_tls_args(p)
    _add_device_arg(p, "the sampler")
    p.set_defaults(fn=cmd_explorer)

    p = sub.add_parser("webcam-serve", help="webcam demo HTTP service")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out-dir", default="/tmp/gifgan_webcam")
    p.add_argument("--paths-dir", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8081)
    p.add_argument("--num-steps", type=int, default=1200)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--auth-token", default=None,
                   help="require Authorization: Bearer <token> on /animate")
    p.add_argument("--warmup", action="store_true",
                   help="run one inversion before serving")
    _add_tls_args(p)
    _add_device_arg(p, "the inversion")
    p.set_defaults(fn=cmd_webcam_serve)

    p = sub.add_parser("eval-fad",
                       help="Fréchet activation distance between two image "
                            "dirs under a trained image-D embedding")
    p.add_argument("--checkpoint", required=True,
                   help="run_dir/checkpoints of a train-dcgan run (the D "
                        "provides the feature space)")
    p.add_argument("--real-dir", required=True)
    p.add_argument("--fake-dir", required=True)
    p.add_argument("--batch-size", type=int, default=256)
    _add_device_arg(p, "the feature extraction")
    p.set_defaults(fn=cmd_eval_fad)

    p = sub.add_parser("eval-track-rate",
                       help="face-track-rate metric over sample dirs")
    p.add_argument("--sample-dirs", nargs="+", required=True)
    p.add_argument("--cascade", required=True)
    p.add_argument("--out-dir", default=None)
    p.add_argument("--limit", type=int, default=250)
    p.add_argument("--upscale", type=int, default=2)
    _add_device_arg(p, "the detector and the flow")
    p.set_defaults(fn=cmd_eval_track_rate)

    p = sub.add_parser("face-detect",
                       help="detect/rank faces in a single image")
    p.add_argument("--image", required=True)
    p.add_argument("--cascade", required=True)
    p.add_argument("--min-size", type=int, default=20)
    p.add_argument("--best", action="store_true")
    p.add_argument("--biggest", action="store_true")
    p.add_argument("--query", default=None,
                   help="face image to search for (MSSIM)")
    _add_device_arg(p, "the detector and the ranking")
    p.set_defaults(fn=cmd_face_detect)

    p = sub.add_parser("survey-serve",
                       help="host exported survey samples + collect ratings")
    p.add_argument("--sample-dir", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8082)
    _add_tls_args(p)
    p.set_defaults(fn=cmd_survey_serve)

    p = sub.add_parser(
        "survey-pairs",
        help="randomized A/B pair manifest + MTurk CSV from an exported "
             "survey sample dir (reference mturk/randomize_csv.py)")
    p.add_argument("--sample-dir", required=True)
    p.add_argument("--variant-a", required=True)
    p.add_argument("--variant-b", required=True)
    p.add_argument("--n", type=int, default=None,
                   help="pair count (default: all available)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--url-prefix", default="",
                   help="prepended to file names in pairs.csv (the hosted "
                        "base URL for an external MTurk HIT)")
    p.set_defaults(fn=cmd_survey_pairs)

    p = sub.add_parser("bench")
    _add_device_arg(p, "the benchmark")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "ckpt-downgrade",
        help="TF V2 bundle (or V1) -> V1 TensorSlice file, no TF needed "
             "(reference utils/downgrade_tf_checkpoint.py)")
    p.add_argument("--input-prefix", required=True,
                   help="TF checkpoint prefix (path to .index's prefix, "
                        "or a V1 file)")
    p.add_argument("--output", required=True, help="output V1 file path")
    p.set_defaults(fn=cmd_ckpt_downgrade)

    p = sub.add_parser("ckpt-inspect",
                       help="list keys/shapes/dtypes of a checkpoint "
                            "(ours or a TF bundle)")
    p.add_argument("path", help="gifgan checkpoint dir or TF prefix")
    p.set_defaults(fn=cmd_ckpt_inspect)
    return ap


def main(argv=None) -> int:
    from gifgan_tpu_torch.parallel.distributed import initialize

    args = build_parser().parse_args(argv)
    initialize(device=getattr(args, "device", None))
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
