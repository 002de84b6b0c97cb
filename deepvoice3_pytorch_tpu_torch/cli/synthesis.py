# coding: utf-8
"""Synthesize waveforms from a checkpoint, counterpart of the root
synthesis.py:

    python -m deepvoice3_pytorch_tpu_torch.cli.synthesis [options] \\
        <checkpoint> <text_list_file> <dst_dir>

Each non-empty line of the text file becomes <dst_dir>/<i>_<checkpoint
name><suffix>.wav with a .txt caption beside it, and an _alignment.png when
matplotlib imports; --output-html adds an index.html. Lines go through the
port's tts_batch (--batch-size at a time; kernels B1 and B2 on the card) or,
with --stream, tts_stream, which prints each batch's first-chunk latency.
The checkpoint is read by training/checkpoint.py: the port's files and the
JAX package's alike.

--data-parallel splits each batch's sentences over the ranks of a torchrun
launch (python -m torch.distributed.run --nproc-per-node N -m
deepvoice3_pytorch_tpu_torch.cli.synthesis --data-parallel ...; one card a
rank, or gloo with --device cpu) through tts_batch(mesh=); rank 0 alone
writes the files. Without torchrun it is a mesh of one process, as the root
script's on one device. The port always decodes with kernel B1 (or its plain
version with --device cpu), so the root script's --fused has no
counterpart; --stream does not compose with --data-parallel, as there.
"""

import argparse
import json
import os
import time
from os.path import basename, join, splitext

import numpy as np
import torch

from .. import frontend as frontend_pkg
from .. import streaming
from ..dsp.audio import AudioProcessor
from ..hparams import hparams_debug_string
from ..model_builder import build_model
from ..parallel import mesh as mesh_lib
from ..synthesis import tts_batch
from ..training import checkpoint as ckpt
from . import common


def stream_batch(params, cfg, ap, frontend_mod, texts, p, spk,
                 max_decoder_steps):
    """--stream: tts_stream over the batch; prints the first-chunk latency
    and returns per-text waveforms trimmed to their decoded lengths with
    their alignments, and the latency in ms."""
    device = next(params.parameters()).device
    gen = streaming.tts_stream(params, cfg, ap, frontend_mod, texts, p=p,
                               speaker_ids=spk,
                               max_decoder_steps=max_decoder_steps,
                               emit_alignment=True)
    t0 = time.perf_counter()
    chunks, first_ms = [], None
    for i, c in enumerate(gen):
        if i == 0:
            first_ms = (time.perf_counter() - t0) * 1e3
            print("  first audio after %.1f ms (%.3f s of audio)"
                  % (first_ms, c["audio"].shape[1] / ap.sample_rate))
        chunks.append(c)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    audio = np.concatenate([c["audio"] for c in chunks], axis=1)
    dec = chunks[-1]["decoded_steps"]
    align = chunks[-1]["alignment"]
    results = []
    for i in range(len(texts)):
        n = streaming.decoded_samples(cfg, ap, dec[i])
        results.append({"waveform": audio[i, :n],
                        "alignment": align[i, :int(dec[i])],
                        "num_decoder_steps": int(dec[i])})
    return results, first_ms


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("checkpoint")
    p.add_argument("text_list_file")
    p.add_argument("dst_dir")
    p.add_argument("--hparams", type=str, default="")
    p.add_argument("--preset", type=str, default=None)
    p.add_argument("--checkpoint-seq2seq", type=str, default=None,
                   help="with --checkpoint-postnet: load the two halves "
                        "instead of <checkpoint>")
    p.add_argument("--checkpoint-postnet", type=str, default=None)
    p.add_argument("--file-name-suffix", type=str, default="")
    p.add_argument("--max-decoder-steps", type=int, default=500)
    p.add_argument("--replace_pronunciation_prob", type=float, default=0.0)
    p.add_argument("--speaker_id", type=int, default=None,
                   help="speaker of a multi-speaker model")
    p.add_argument("--batch-size", type=int, default=1,
                   help="synthesize N sentences at once")
    p.add_argument("--stream", action="store_true",
                   help="synthesize with the streaming pipeline "
                        "(streaming.tts_stream) and print each batch's "
                        "first-chunk latency")
    p.add_argument("--data-parallel", action="store_true",
                   help="split each batch over the ranks of a torchrun "
                        "launch (one process without torchrun)")
    p.add_argument("--output-html", action="store_true")
    p.add_argument("--warmup", action="store_true",
                   help="synthesize the first batch once, in the run's "
                        "mode, before the run, neither counted nor "
                        "written (loads the kernels, packs the decoder's "
                        "weights, builds the libraries' plans)")
    common.add_device_argument(p)
    p.add_argument("--summary-json", type=str, default=None,
                   help="write per-batch wall ms, decoded steps, audio "
                        "seconds and the kernels' launch counts here")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.stream and args.data_parallel:
        raise SystemExit("--stream does not compose with --data-parallel")
    device = common.init_distributed(args.device)
    distributed = device is not None
    device = device or common.pick_device(args.device)
    try:
        mesh = common.make_run_mesh(device) if args.data_parallel else None
        _synthesize(args, device, mesh)
    finally:
        if distributed:
            torch.distributed.destroy_process_group()


def _synthesize(args, device, mesh):
    main_rank = mesh_lib.is_main(mesh)
    hp = common.load_hparams(args.preset, args.hparams)
    if main_rank:
        print(hparams_debug_string(hp))

    fe = frontend_pkg.get_frontend(hp.frontend)
    cfg, params = build_model(hp, fe.n_vocab, device=device)
    if args.checkpoint_seq2seq and args.checkpoint_postnet:
        ckpt.restore_parts(args.checkpoint_seq2seq, params)
        ckpt.restore_parts(args.checkpoint_postnet, params)
        checkpoint_name = splitext(basename(args.checkpoint_seq2seq))[0]
    else:
        ckpt.load_checkpoint(args.checkpoint, params, reset_optimizer=True)
        checkpoint_name = splitext(basename(args.checkpoint))[0]

    ap = AudioProcessor(hp)
    if main_rank:
        os.makedirs(args.dst_dir, exist_ok=True)
    with open(args.text_list_file, "rb") as f:
        lines = [l.decode("utf-8").strip() for l in f if l.strip()]

    if args.warmup and lines:
        texts = lines[:args.batch_size]
        spk = None if args.speaker_id is None \
            else [args.speaker_id] * len(texts)
        if args.stream:
            stream_batch(params, cfg, ap, fe, texts, 0.0, spk,
                         args.max_decoder_steps)
        else:
            tts_batch(params, cfg, ap, fe, texts, speaker_ids=spk,
                      max_decoder_steps=args.max_decoder_steps, mesh=mesh)
        common.reset_launches()
    mpl = common.pyplot()
    summary = {"device": str(device), "batches": []}
    html_rows = []
    for s in range(0, len(lines), args.batch_size):
        texts = lines[s:s + args.batch_size]
        spk = None if args.speaker_id is None \
            else [args.speaker_id] * len(texts)
        t0 = time.perf_counter()
        first_ms = None
        if args.stream:
            results, first_ms = stream_batch(
                params, cfg, ap, fe, texts, args.replace_pronunciation_prob,
                spk, args.max_decoder_steps)
        else:
            results = tts_batch(params, cfg, ap, fe, texts,
                                p=args.replace_pronunciation_prob,
                                speaker_ids=spk,
                                max_decoder_steps=args.max_decoder_steps,
                                mesh=mesh)
        wall_ms = (time.perf_counter() - t0) * 1e3   # results are on the
        # host: the device's work is done
        if not main_rank:          # every rank has every result
            continue
        audio_s = sum(len(r["waveform"]) for r in results) / ap.sample_rate
        summary["batches"].append({
            "n": len(texts), "wall_ms": wall_ms, "audio_s": audio_s,
            "first_chunk_ms": first_ms,
            "decoded_steps": [r["num_decoder_steps"] for r in results]})
        print("batch of %d: %.1f ms for %.2f s of audio" % (
            len(texts), wall_ms, audio_s))
        for j, (text, res) in enumerate(zip(texts, results)):
            idx = s + j
            name = "{}_{}{}".format(idx, checkpoint_name,
                                    args.file_name_suffix)
            dst_wav_path = join(args.dst_dir, name + ".wav")
            dst_alignment_path = join(args.dst_dir, name + "_alignment.png")
            if mpl is not None:
                common.plot_alignment(mpl[0], res["alignment"].T,
                               dst_alignment_path, info="{}, {}".format(
                                   hp.builder, basename(args.checkpoint)))
            ap.save_wav(res["waveform"], dst_wav_path)
            with open(join(args.dst_dir, name + ".txt"), "w",
                      encoding="utf-8") as f:
                f.write(text + "\n")
            print(idx, ": {}\n ({} chars, {} words)".format(
                text, len(text), len(text.split())))
            if args.output_html:
                html_rows.append(
                    "<figure>\n<figcaption>{}</figcaption>\n"
                    "<audio controls src=\"{}\"></audio>\n"
                    "<img src=\"{}\" width=\"480\">\n</figure>".format(
                        text.replace("<", "&lt;"), basename(dst_wav_path),
                        basename(dst_alignment_path)))

    if not main_rank:
        return
    if args.output_html and html_rows:
        html = ("<!doctype html>\n<meta charset=\"utf-8\">\n"
                "<title>{0}</title>\n<h1>{0}</h1>\n{1}\n").format(
                    checkpoint_name, "\n".join(html_rows))
        html_path = join(args.dst_dir, "index.html")
        with open(html_path, "w", encoding="utf-8") as f:
            f.write(html)
        print("Wrote {}".format(html_path))
    common.print_launches()
    if args.summary_json:
        summary["launches"] = common.kernel_launches()
        with open(args.summary_json, "w") as f:
            json.dump(summary, f, indent=1)
    print("Finished! Check out {} for generated audio samples.".format(
        args.dst_dir))


if __name__ == "__main__":
    main()
