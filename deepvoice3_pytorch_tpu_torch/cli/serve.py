# coding: utf-8
"""Streaming TTS over HTTP from a checkpoint, counterpart of the root
serve.py:

    python -m deepvoice3_pytorch_tpu_torch.cli.serve <checkpoint> \\
        --preset=presets/deepvoice3_ljspeech.json [--slots 8]

GET /tts?text=...[&speaker_id=N] streams chunked WAV as it is synthesized;
/healthz and /stats as serve.make_handler documents. --slots N decodes up to
N requests together (continuous batching), else one at a time. The address
it listens on is printed once it is up (--port 0 picks a free port). On
SIGINT or SIGTERM it stops and prints the kernels' launch counts.
"""

import argparse
import signal

from .. import frontend as frontend_pkg
from ..dsp.audio import AudioProcessor
from ..model_builder import build_model
from ..serve import TTSEngine, TTSServer, make_handler
from ..training import checkpoint as ckpt
from . import common


def build_engine(checkpoint, preset=None, hparams_str="",
                 max_decoder_steps=500, slots=0, max_backlog=None,
                 device="cuda"):
    """A TTSEngine over the checkpoint's parameters on `device`."""
    device = common.pick_device(device)
    hp = common.load_hparams(preset, hparams_str)
    fe = frontend_pkg.get_frontend(hp.frontend)
    cfg, params = build_model(hp, fe.n_vocab, device=device)
    ckpt.load_checkpoint(checkpoint, params, reset_optimizer=True)
    ap = AudioProcessor(hp)
    return TTSEngine(params, cfg, ap, fe, max_decoder_steps, slots=slots,
                     max_backlog=max_backlog)


def _stop(signum, frame):
    raise KeyboardInterrupt


def main(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("checkpoint")
    parser.add_argument("--hparams", type=str, default="")
    parser.add_argument("--preset", type=str, default=None)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8585)
    parser.add_argument("--max-decoder-steps", type=int, default=500)
    parser.add_argument("--slots", type=int, default=0,
                        help="continuous batching: decode up to N "
                             "utterances together; 0 = one at a time")
    parser.add_argument("--max-backlog", type=int, default=None,
                        help="with --slots: answer 503 once this many "
                             "requests wait for a slot [default: 8*slots]")
    common.add_device_argument(parser)
    args = parser.parse_args(argv)

    engine = build_engine(args.checkpoint, args.preset, args.hparams,
                          args.max_decoder_steps, slots=args.slots,
                          max_backlog=args.max_backlog, device=args.device)
    print("warming up...", flush=True)
    engine.warmup()
    server = TTSServer((args.host, args.port), make_handler(engine))
    signal.signal(signal.SIGTERM, _stop)
    print("serving on http://%s:%d  (GET /tts?text=...)"
          % server.server_address[:2], flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.shutdown()
        common.print_launches()


if __name__ == "__main__":
    main()
