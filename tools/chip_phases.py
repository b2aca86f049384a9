"""Run some of ``chip_smoke.py``'s module-level phases alone on the card.

    python3 tools/chip_phases.py checkpoint helpers remat
    python3 tools/chip_phases.py serve
    python3 tools/chip_phases.py mesh
    python3 tools/chip_phases.py serve_mesh

Each name is a ``<name>_phase`` function of ``chip_smoke.py`` (``serve_mesh``
runs the ``serve-mesh:`` phase); they run in
the order given, after the kernels are built (outside every timed span),
with the script's matmul settings, and print their lines and the launches
they return.  Exits non-zero on a failed phase, as the script does.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(names) -> None:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is false: the phases need an NVIDIA GPU")
    phases = [getattr(chip_smoke, f"{n}_phase", None) for n in names]
    if not names or None in phases:
        chip_smoke.fail(f"name phases of chip_smoke.py, got {names}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build

    print(f"build: {build.library().seconds:.2f} s")
    dev, card = torch.device("cuda", 0), torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    for name, phase in zip(names, phases):
        print(f"{name}: launches {phase(dev, card)}")
    print(f"phases {names} took {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1:])
