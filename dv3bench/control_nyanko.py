# coding: utf-8
"""control.py for the cells of traffic kind `nyanko_batch_synthesis`,
whose planted faults are batch_synthesis's (faults.py: they wrap the same
tts_batch):

    python3 dv3bench/control_nyanko.py --workload nyanko_ljspeech.batch32 \
        --seconds <s> --seeds <n>[,<n>...] [--fault <name>] [--out <file>]

Needs a CUDA device."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from dv3bench import control, faults  # noqa: E402

faults.BY_KIND.setdefault("nyanko_batch_synthesis",
                          faults.BY_KIND["batch_synthesis"])

if __name__ == "__main__":
    sys.exit(control.main())
