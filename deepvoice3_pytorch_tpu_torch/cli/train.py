# coding: utf-8
"""Train a model, counterpart of the root train.py:

    python -m deepvoice3_pytorch_tpu_torch.cli.train \\
        --preset=presets/deepvoice3_ljspeech.json --data-root=<dir> \\
        --checkpoint-dir=checkpoints [--device cpu]

It takes every flag of the root script but --mesh-model (one card), and
adds --device (default cuda), --seed and --conv-mode (default kernel: the
step's convolutions run kernel B3, its plain version on the CPU). Any of the
three builders trains, as the preset names.

Resuming (--checkpoint) continues the run that wrote the file: the sampler
is replayed to the saved epoch and the batches of that epoch already taken
are skipped, the pronunciation mix draws from Python's `random` seeded
from (seed, epoch), and dropout draws from a generator on the device seeded
from (seed, global step); so the resumed run takes the steps the
uninterrupted one would.

Checkpoints go to --checkpoint-dir every `checkpoint_interval` steps and at
the end (with the alignment images when matplotlib imports, the predicted
wav, and TensorBoard records when tensorboardX imports); every
`eval_interval` steps six sentences are synthesized with the port's
`tts_batch` into <checkpoint-dir>/eval. A kernel or save error ends the run.
--summary-json writes the run's numbers: per-step losses, steady steps/s,
save and load times, file sizes and the kernels' launch counts.
"""

import argparse
import itertools
import json
import os
import random
import time
from datetime import datetime
from os.path import join

import numpy as np
import torch

from .. import frontend as frontend_pkg
from ..builder import model_forward
from ..dsp.audio import AudioProcessor
from ..hparams import hparams_debug_string
from ..model_builder import build_model
from ..synthesis import tts_batch
from ..training import checkpoint as ckpt
from ..training import dataset, trainer
from ..utils import profiling
from . import common

EVAL_TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "In 1876, Alexander Graham Bell was awarded a patent for the telephone.",
    "Synthesis quality depends on attention staying monotonic across long, "
    "winding sentences such as this one.",
    "Dr. Smith owes the bank twelve hundred dollars and fifty cents.",
    "Stop right there.",
    "Could machines ever learn to speak with genuine feeling?",
]


def _add_audio(writer, tag, wav, step, sample_rate):
    """TensorBoard audio; tensorboardX encodes it with soundfile, which may
    be absent."""
    if writer is None:
        return
    try:
        writer.add_audio(tag, wav[None, :], step, sample_rate=sample_rate)
    except ImportError:
        pass


def save_states(global_step, writer, outputs, batch, checkpoint_dir, ap):
    """The predicted wav of one batch item (Griffin-Lim on the device), and
    with matplotlib the alignment images, with tensorboardX the image and
    audio records."""
    mel_outputs, linear_outputs, attn, _ = outputs
    idx = min(1, len(batch["x"]) - 1)
    mpl = common.pyplot()
    if mpl is not None:
        plt, cm = mpl
        attn = attn.float().cpu().numpy()
        for i, alignment in enumerate(attn):
            common.plot_alignment(plt, alignment[idx], join(
                checkpoint_dir, "step%09d_layer_%d_alignment.png"
                % (global_step, i)))
            if writer is not None:
                writer.add_image("alignment_layer{}".format(i + 1),
                                 np.uint8(cm.viridis(alignment[idx]) * 255),
                                 global_step, dataformats="HWC")
        common.plot_alignment(plt, attn.mean(0)[idx], join(
            checkpoint_dir, "step%09d_alignment.png" % global_step))

        def spec_image(spec):
            s = np.clip(np.flip(np.asarray(spec).T, axis=0), 0.0, 1.0)
            return np.uint8(cm.magma(s) * 255)

        if writer is not None:
            writer.add_image("predicted_mel_spectrogram", spec_image(
                mel_outputs[idx].float().cpu().numpy()), global_step,
                dataformats="HWC")
            writer.add_image("target_mel_spectrogram", spec_image(
                batch["mel"][idx].cpu().numpy()), global_step,
                dataformats="HWC")
            if linear_outputs is not None:
                writer.add_image("predicted_linear_spectrogram", spec_image(
                    linear_outputs[idx].float().cpu().numpy()), global_step,
                    dataformats="HWC")
                writer.add_image("target_linear_spectrogram", spec_image(
                    batch["y"][idx].cpu().numpy()), global_step,
                    dataformats="HWC")
    if linear_outputs is not None:
        wav = ap.inv_spectrogram_device(
            linear_outputs[idx:idx + 1].float())[0].cpu().numpy()
        ap.save_wav(wav, join(checkpoint_dir,
                              "step%09d_predicted.wav" % global_step))
        _add_audio(writer, "predicted_audio", wav, global_step,
                   ap.sample_rate)


def eval_model(global_step, writer, params, cfg, ap, frontend_mod,
               checkpoint_dir, max_decoder_steps=500):
    """Synthesize the fixed eval sentences with tts_batch (kernels B1 and
    B2 on the card) into <checkpoint_dir>/eval; a multi-speaker model
    speaks them as speakers 0, 1 and the last. Returns the paths."""
    eval_dir = join(checkpoint_dir, "eval")
    os.makedirs(eval_dir, exist_ok=True)
    speaker_ids = [None] if cfg.n_speakers <= 1 \
        else [0, 1, cfg.n_speakers - 1]
    paths = []
    for speaker_id in speaker_ids:
        spk = None if speaker_id is None else [speaker_id] * len(EVAL_TEXTS)
        results = tts_batch(params, cfg, ap, frontend_mod, EVAL_TEXTS, p=0,
                            speaker_ids=spk,
                            max_decoder_steps=max_decoder_steps)
        for i, res in enumerate(results):
            tag = "eval_{}_{}".format(
                i, speaker_id if speaker_id is not None else "single")
            path = join(eval_dir, "step%09d_%s.wav" % (global_step, tag))
            ap.save_wav(res["waveform"], path)
            paths.append(path)
            _add_audio(writer, tag, res["waveform"], global_step,
                       ap.sample_rate)
    return paths


def device_batches(host_batches, device):
    """Collated numpy batches -> tensors on `device`. On the card each batch
    goes from pinned memory with a non-blocking copy on a stream of its
    own, issued while the previous batch's step runs; the step's stream
    waits for it before use."""
    if device.type != "cuda":
        for batch in host_batches:
            yield trainer.batch_to(batch, device)
        return
    stream = torch.cuda.Stream(device)
    pending = None
    for batch in host_batches:
        with torch.cuda.stream(stream):
            placed = {}
            for k, v in batch.items():
                t = torch.as_tensor(v)
                t = t.long() if not t.is_floating_point() else t.float()
                placed[k] = t.pin_memory().to(device, non_blocking=True)
        ready = stream.record_event()
        if pending is not None:
            yield _wait(pending, device)
        pending = (placed, ready)
    if pending is not None:
        yield _wait(pending, device)


def _wait(pending, device):
    placed, ready = pending
    main = torch.cuda.current_stream(device)
    main.wait_event(ready)
    for t in placed.values():
        t.record_stream(main)
    return placed


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--data-root", type=str, default=None,
                   help="directory of preprocessed features")
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--hparams", type=str, default="",
                   help="hyper parameters, e.g. 'batch_size=8,nepochs=1'")
    p.add_argument("--preset", type=str, default=None,
                   help="preset parameters (json)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="resume from this checkpoint")
    p.add_argument("--checkpoint-seq2seq", type=str, default=None)
    p.add_argument("--checkpoint-postnet", type=str, default=None)
    p.add_argument("--train-seq2seq-only", action="store_true")
    p.add_argument("--train-postnet-only", action="store_true")
    p.add_argument("--restore-parts", type=str, default=None,
                   help="shape-tolerant restore from this checkpoint")
    p.add_argument("--async-checkpoint", action="store_true",
                   help="write periodic checkpoints from a background "
                        "thread after a device snapshot")
    p.add_argument("--log-event-path", type=str, default=None)
    p.add_argument("--reset-optimizer", action="store_true")
    p.add_argument("--load-embedding", type=str, default=None,
                   help="take the text embedding from this checkpoint")
    p.add_argument("--speaker-id", type=int, default=None,
                   help="train on this speaker's rows only")
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after N steps (default: nepochs epochs)")
    p.add_argument("--profile-dir", type=str, default=None,
                   help="write a torch.profiler Chrome trace to this dir")
    p.add_argument("--profile-start", type=int, default=10,
                   help="first step of the profiler trace window")
    p.add_argument("--profile-steps", type=int, default=5,
                   help="number of steps to trace")
    common.add_device_argument(p)
    p.add_argument("--seed", type=int, default=1234,
                   help="seed of the initial weights, the dropout draws "
                        "and the pronunciation mix")
    p.add_argument("--conv-mode", default="kernel",
                   choices=("kernel", "library"),
                   help="kernel: the step's convolutions run kernel B3; "
                        "library: F.conv1d [default: kernel]")
    p.add_argument("--summary-json", type=str, default=None,
                   help="write the run's numbers to this JSON file")
    return p


def _restore(args, params, opt_state):
    """Apply --checkpoint (exact resume), the halves, --restore-parts and
    --load-embedding. Returns (opt_state or None, step, epoch, load ms)."""
    global_step, global_epoch, load_ms = 0, 0, None
    if args.checkpoint is not None:
        t = time.perf_counter()
        _, opt_state, global_step, global_epoch = ckpt.load_checkpoint(
            args.checkpoint, params, opt_state,
            reset_optimizer=args.reset_optimizer)
        _sync(next(params.parameters()).device)
        load_ms = (time.perf_counter() - t) * 1e3
        print("Loaded %s (step %d, epoch %d) in %.1f ms"
              % (args.checkpoint, global_step, global_epoch, load_ms))
    else:
        opt_state = None
    for path in (args.checkpoint_seq2seq, args.checkpoint_postnet,
                 args.restore_parts):
        if path is not None:
            ckpt.restore_parts(path, params)
    if args.load_embedding is not None:
        ckpt.load_embedding(args.load_embedding, params)
    return opt_state, global_step, global_epoch, load_ms


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = common.pick_device(args.device)
    hp = common.load_hparams(args.preset, args.hparams)
    print(hparams_debug_string(hp))

    train_seq2seq = not args.train_postnet_only
    train_postnet = not args.train_seq2seq_only
    if not (train_seq2seq or train_postnet):
        raise SystemExit("--train-seq2seq-only and --train-postnet-only "
                         "exclude each other")
    if not train_seq2seq and hp.use_decoder_state_for_postnet_input:
        raise SystemExit(
            "--train-postnet-only requires "
            "use_decoder_state_for_postnet_input=false: with it on, the "
            "converter consumes decoder states, which postnet-only training "
            "has no way to produce. Override with "
            "--hparams=use_decoder_state_for_postnet_input=false (the "
            "seq2seq half must have been trained the same way).")

    fe = frontend_pkg.get_frontend(hp.frontend)
    ap = AudioProcessor(hp)
    data_root = args.data_root or join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "data", "ljspeech")
    dataset.check_dsp_stamp(data_root, hp)
    ds = dataset.TTSDataset(data_root, fe, hp.replace_pronunciation_prob,
                            speaker_id=args.speaker_id)
    sampler = dataset.SimilarTimeLengthSampler(ds.meta.frame_lengths,
                                               batch_size=hp.batch_size)
    loader = dataset.DataLoader(
        ds, sampler, r=hp.outputs_per_step,
        downsample_step=hp.downsample_step,
        length_bucket_step=hp.length_bucket_step,
        frame_bucket_step=hp.frame_bucket_step,
        max_positions=hp.max_positions)
    n_batches = len(ds) // hp.batch_size
    if n_batches == 0:
        raise SystemExit("%d utterances make no batch of %d"
                         % (len(ds), hp.batch_size))

    cfg, params = build_model(hp, fe.n_vocab, seed=args.seed, device=device)
    lc = trainer.loss_config_from_hparams(hp)._replace(
        train_seq2seq=train_seq2seq, train_postnet=train_postnet)
    lr_fn = trainer.make_lr_fn(hp)
    optimizer = trainer.make_optimizer(hp, lr_fn)
    mask = trainer.trainable_mask(params, cfg, train_seq2seq=train_seq2seq,
                                  train_postnet=train_postnet)
    state = trainer.init_train_state(params, optimizer)
    opt_state, global_step, global_epoch, load_ms = _restore(
        args, params, state.opt_state)
    if opt_state is None:                # a fresh (or reset) optimizer
        opt_state = state.opt_state
    state = trainer.TrainState(params, opt_state, global_step)
    step_fn = trainer.make_train_step(cfg, lc, optimizer, mask,
                                      compute_dtype=hp.compute_dtype,
                                      conv_mode=args.conv_mode)

    writer = None
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        SummaryWriter = None
    if SummaryWriter is not None:
        log_path = args.log_event_path or "log/run-test%s" % (
            datetime.now().strftime("%Y%m%d%H%M%S"))
        writer = SummaryWriter(log_path)
        print("TensorBoard event log path: %s" % log_path)

    os.makedirs(args.checkpoint_dir, exist_ok=True)
    gen = torch.Generator(device=device)
    step_timer = profiling.StepTimer()
    tracer = profiling.TraceWindow(args.profile_dir, args.profile_start,
                                   args.profile_steps)
    summary = {"device": str(device), "first_step": global_step + 1,
               "losses": [], "save_ms": [], "async_stall_ms": [],
               "eval_ms": [], "load_ms": load_ms, "files": {}}
    steady = {"t": None, "steps": 0, "excluded_s": 0.0}

    def save(step, batch, async_save):
        with torch.no_grad():
            outputs = model_forward(
                state.params, cfg, batch["x"], batch["mel"],
                speaker_ids=batch.get("speaker_ids"),
                text_positions=batch["text_positions"],
                frame_positions=batch["frame_positions"],
                input_lengths=batch["input_lengths"])
        save_states(step, writer, outputs, batch, args.checkpoint_dir, ap)
        _sync(device)
        t_ck = time.perf_counter()
        path = ckpt.save_checkpoint(
            args.checkpoint_dir, state.params, state.opt_state, step,
            global_epoch, train_seq2seq=train_seq2seq,
            train_postnet=train_postnet,
            save_optimizer_state=hp.save_optimizer_state,
            async_save=async_save)
        ms = (time.perf_counter() - t_ck) * 1e3
        summary["async_stall_ms" if async_save else "save_ms"].append(
            round(ms, 3))
        summary["files"][os.path.basename(path)] = None

    def fetch_losses(running):
        summary["losses"] += [float(v) for v in running]

    print("Starting training (%d utterances, batch %d) on %s"
          % (len(ds), hp.batch_size, device))
    # replay the sampler to the saved epoch and skip the batches of it that
    # the saved run took (a save at an epoch's last step precedes the
    # epoch's count)
    extra, skip = divmod(global_step - global_epoch * n_batches, n_batches)
    if extra < 0:
        print("note: step %d comes before epoch %d of %d batches; the "
              "epoch starts from its first batch"
              % (global_step, global_epoch, n_batches))
        extra, skip = 0, 0
    global_epoch += extra
    for _ in range(global_epoch):
        for _ in sampler:
            pass
    running = []
    try:
        while global_epoch < hp.nepochs:
            running = []
            t_epoch = time.time()
            random.seed(args.seed * 1000003 + global_epoch)
            host = itertools.islice(iter(loader), skip, None)
            skip = 0
            for batch in device_batches(host, device):
                tracer.maybe_start(global_step)
                gen.manual_seed(args.seed * 1000003 + global_step)
                state, metrics = step_fn(state, batch, gen)
                global_step += 1
                step_timer.tick()
                tracer.maybe_stop(global_step)
                running.append(metrics["loss"])
                if steady["t"] is None and global_step - summary[
                        "first_step"] >= 2:
                    _sync(device)        # steady from the third step on
                    steady["t"] = time.perf_counter()
                elif steady["t"] is not None:
                    steady["steps"] += 1

                if global_step % 50 == 0 or global_step < 5:
                    m = {k: float(v) for k, v in metrics.items()}
                    perf = step_timer.report(writer, global_step)
                    print("step %d | loss %.4f | %s%s"
                          % (global_step, m["loss"],
                             " ".join("%s %.4f" % (k, v)
                                      for k, v in sorted(m.items())
                                      if k != "loss"),
                             (" | " + perf) if perf else ""))
                if writer is not None and global_step % 10 == 0:
                    for k, v in metrics.items():
                        writer.add_scalar(k, float(v), global_step)
                    writer.add_scalar("learning rate",
                                      float(lr_fn(global_step)),
                                      global_step)

                t = time.perf_counter()
                if global_step % hp.checkpoint_interval == 0:
                    save(global_step, batch, args.async_checkpoint)
                if global_step % hp.eval_interval == 0:
                    t_eval = time.perf_counter()
                    eval_model(global_step, writer, state.params, cfg, ap,
                               fe, args.checkpoint_dir,
                               hp.max_decoder_steps)
                    _sync(device)
                    summary["eval_ms"].append(
                        round((time.perf_counter() - t_eval) * 1e3, 3))
                if steady["t"] is not None:   # saves and evals are not steps
                    steady["excluded_s"] += time.perf_counter() - t
                if args.max_steps and global_step >= args.max_steps:
                    raise KeyboardInterrupt
            global_epoch += 1
            fetch_losses(running)
            epoch_loss = float(np.mean([float(x) for x in running])) \
                if running else float("nan")
            print("epoch %d done in %.1fs | avg loss %.4f"
                  % (global_epoch, time.time() - t_epoch, epoch_loss))
            if writer is not None and running:
                writer.add_scalar("loss (per epoch)", epoch_loss,
                                  global_epoch)
    except KeyboardInterrupt:
        fetch_losses(running)
        print("Interrupted -- saving checkpoint")
    _sync(device)
    if steady["t"] is not None and steady["steps"]:
        summary["steady_steps_per_s"] = steady["steps"] / (
            time.perf_counter() - steady["t"] - steady["excluded_s"])
    tracer.close()
    ckpt.wait_pending_saves()
    t = time.perf_counter()
    path = ckpt.save_checkpoint(
        args.checkpoint_dir, state.params, state.opt_state, global_step,
        global_epoch, train_seq2seq=train_seq2seq,
        train_postnet=train_postnet,
        save_optimizer_state=hp.save_optimizer_state)
    summary["save_ms"].append(round((time.perf_counter() - t) * 1e3, 3))
    summary["files"][os.path.basename(path)] = None
    print("Saved final checkpoint at step %d: %s" % (global_step, path))
    common.print_launches()
    if args.summary_json:
        summary["files"] = {k: os.path.getsize(join(args.checkpoint_dir, k))
                            for k in summary["files"]}
        summary.update(last_step=global_step, epoch=global_epoch,
                       launches=common.kernel_launches())
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1)


if __name__ == "__main__":
    main()
