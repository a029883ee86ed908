"""The reference models, one module a model family, found by import from the
configuration's `model.name`: `families/<name>.py`.  There is no list to
edit.

A family module provides:

  supported(cfg)             raises ValueError, with the reason, for an
                             option of `cfg` that its reference does not
                             write out (an encoder, a rotation head, ...).
  build(params, cfg, prec)   the model over the named leaves `params`
                             (name -> tensor, the program's parameter
                             names), computing in `prec`
                             (model.Precision): an object with
                             `precompute(batch)` -> features shared by the
                             MoN samples, and `sample(feats, generator)` ->
                             (quat, trans), either [B, P, .] or, for a
                             family that supervises each of T rounds,
                             [T, B, P, .]; the draws of a sample (noise)
                             come from `generator`, dropout's masks from
                             the device's default generator.
  iterations(cfg)            the supervised iterations of a sample: T, the
                             leading axis of a stacked prediction, or 1.
                             The loss sums each term over them, and the
                             chamfer runs once for each.
  model_flops(cfg, counts)   forward plus backward FLOPs of the trained
                             matmuls of one step whose shapes have `counts`
                             valid parts (harness/flops.py's rules).

The module is plain PyTorch and numpy, in f32 or at the rounding points of
the configuration's `exp.bf16`; it imports neither JAX nor anything of the
program under test, and builds only from the leaves it is given.

A new family joins the benchmark with files only: this module, its
configuration `benchmark/configs/<config>.json`, a traffic file where its
data or wire is new, and `benchmark/workloads/<cell>.json` with the limits
of its check, beside the BENCHMARK.json entries.
"""

import importlib


def family(cfg):
    """The family module of `cfg['model']['name']`."""
    name = str(cfg['model']['name'])
    module = f'{__name__}.{name}'
    missing = ValueError(
        f'no reference for the model family {name!r}: add '
        f'benchmark/reference/families/{name}.py (its contract: '
        f'benchmark/reference/families/__init__.py)')
    if not name.isidentifier():
        raise missing
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        raise missing from None
