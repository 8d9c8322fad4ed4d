"""benchmark/calibrate.py with the PredNet faults (benchmark/prednet_faults.py)
in place of the video GAN's:

    python3 -m benchmark.calibrate_prednet --workload \
        prednet_kitti_corpus_b64 --seeds 11 12 ... --out calib.json
"""

import sys

from benchmark import calibrate, prednet_faults

calibrate.faults = prednet_faults

if __name__ == "__main__":
    sys.exit(calibrate.main())
