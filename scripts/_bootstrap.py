"""Make the repo root importable when scripts run from anywhere.  (The
package import turns on the persistent compilation cache:
vnlb_tpu/utils/cache.py.)"""

import sys
from pathlib import Path

_root = str(Path(__file__).resolve().parent.parent)
if _root not in sys.path:
    sys.path.insert(0, _root)
