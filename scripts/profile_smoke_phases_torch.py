"""cProfile of chip_smoke.py's phases that hold the card against the CPU.

Builds the kernels and the smoke's synthetic sets, then runs
`phase_family_slices`, `phase_semantic_slice` and `phase_encoders` under
cProfile, printing each phase's wall time and its 35 costliest functions
by cumulative and by own time.  It needs one card:

    python3 scripts/profile_smoke_phases_torch.py > profile.log
"""

import cProfile
import io
import os
import pstats
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as S  # noqa: E402


def _profiled(label, phase, *args):
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    phase(*args)
    prof.disable()
    print(f'=== {label}: {time.perf_counter() - t0:.1f} s', flush=True)
    for key in ('cumulative', 'tottime'):
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats(key).print_stats(35)
        print(out.getvalue(), flush=True)


def main():
    S.phase_device()
    with tempfile.TemporaryDirectory() as tmp:
        S.phase_build(tmp)
        os.environ['MPA_MESH_CACHE_DIR'] = os.path.join(tmp, 'mesh_cache')
        data_dir = os.path.join(tmp, 'everyday')
        S._make_everyday_set(data_dir)
        partnet_dir = S._make_partnet_set(os.path.join(tmp, 'partnet'))
        _profiled('family_slices', S.phase_family_slices)
        _profiled('semantic_slice', S.phase_semantic_slice, partnet_dir)
        _profiled('encoders', S.phase_encoders, data_dir, tmp)


if __name__ == '__main__':
    main()
