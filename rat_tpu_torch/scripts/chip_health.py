"""One-line health stamp of the card.

A thin command over rat_tpu_torch.cli.chip_health (the probes, their
marginal-cost method and the ``healthy`` bounds are described there):

    python -m rat_tpu_torch.scripts.chip_health   # one JSON line

``healthy`` means every probe is within its bound, so benchmark numbers
taken on the card are representative. Runs on card 0 and raises without
one; ``RAT_TPU_PLATFORM=cpu`` (or ``device="cpu"``) asks for the CPU,
where the stamp names the platform and runs no probe.
"""

import argparse
import json

from ..cli.chip_health import collect
from . import script_device


def main(argv=None, device=None):
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args(argv)
    stamp = collect(script_device(device))
    print(json.dumps(stamp), flush=True)
    return stamp


if __name__ == "__main__":
    main()
