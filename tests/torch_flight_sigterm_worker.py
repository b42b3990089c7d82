"""Worker of the port's SIGTERM -> flight-dump subprocess test
(``test_torch_telemetry.py``), beside ``flight_sigterm_worker.py``: a
process with records in the port's flight ring receives a SIGTERM, dumps
the ring to $DL4J_TPU_FLIGHT_DIR and dies by the default disposition
(rc == -SIGTERM). It imports the port only (never JAX).

Usage: torch_flight_sigterm_worker.py [n_records]
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from deeplearning4j_tpu_torch import telemetry                     # noqa: E402
from deeplearning4j_tpu_torch.telemetry import flight as _flight   # noqa: E402


def main(argv):
    n = int(argv[1]) if len(argv) > 1 else 5
    telemetry.enable()  # arms the recorder
    rec = _flight.get_recorder()
    for i in range(n):
        rec.note(step=i, score=float(i) * 0.5, step_time_s=0.01)
    installed = _flight.install_signal_handler()
    print(json.dumps({"ready": True, "installed": installed, "records": n}), flush=True)
    time.sleep(120)  # the test SIGTERMs us long before this
    print(json.dumps({"error": "never signaled"}), flush=True)
    return 1


if __name__ == "__main__":
    sys.exit(main(sys.argv))
