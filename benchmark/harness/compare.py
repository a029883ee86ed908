"""The numbers that decide `correct`, and their limits.

Each run's set-up drives the program through its first steps: the first
alone, then one group as `train_epoch` dispatches it (cell.check_steps);
the plain reference (benchmark/reference) follows the same steps from the
same initial weights and the same data, in the compute type the
configuration's precision switch states (reference/model.py).

  loss_gap        the first step's logged loss terms (each term of the
                  MoN-selected samples, a batch mean, and the loss): the
                  widest gap of a term times its weight in the loss, over
                  the reference's loss.  The same weights on the same
                  batch: only the order of the sums parts the two sides.
                  Weighting by the loss keeps a flip between two near-tied
                  MoN samples of a shape, which moves their terms but not
                  the loss, from reading as a gap.
  later_loss_gap  the same, the widest over the later steps (the group).
                  The updates differ by the backward's rounding (the
                  program's is bf16, the reference's f32), and a weight
                  that moves by the lr can cross a bf16 rounding edge, so
                  these read bf16 noise; one step of the group gone wrong
                  reads more.
  grad_gap        the first gradient by the median leaf: for each leaf the
                  gap between the program's norm of its gradient (from
                  Adam's first moment after one step, m / (1 - beta1)) and
                  the reference's, over the reference's norm of that leaf
                  or of the median leaf, whichever is larger.  Adam's
                  update does not change when a gradient is scaled, so
                  only this number sees a backward wrong by a factor; one
                  wrong by k everywhere reads about |k - 1|.
  change_gap      the parameters' change after the steps, by the worst
                  leaf in the same way, over the entries whose reference
                  gradient is not nought (a key's bias under softmax moves
                  by round-off alone under Adam).

A cell compares the numbers that `workloads/<cell>.json` gives limits.
"""

import math


NOUGHT = 1e-3  # gradient under this share of the median leaf's: nought


def _norms(tensors):
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def _median(values):
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] +
                                                    v[len(v) // 2])


def _gaps(prog, ref, names):
    """name -> the gap of a leaf's norms over the reference's norm of that
    leaf or of the median leaf, whichever is larger."""
    med = _median([ref[n] for n in names])
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def _worst(prog, ref, names):
    """(gap, leaf) of the worst leaf."""
    return max((g, n) for n, g in _gaps(prog, ref, names).items())


def _step_gap(a, r, weights):
    """The widest weighted gap of one step's loss terms, each term's gap
    times its weight over the reference's loss."""
    return max(w * abs(a.get(k, math.inf) - r[k])
               for k, w in weights.items()) / max(abs(r['loss']), 1e-30)


def readings(prog, ref, params0, weights, detail=None):
    """The numbers above for a program's (or a stand-in's) first steps
    against the reference's.  Each side is a dict with 'loss' (a dict of
    loss terms a step), 'grad' (name -> first gradient) and 'params'
    (name -> weights after the steps); params0 the initial weights.
    `weights` are the loss terms' weights in the loss.  `detail`, a dict,
    receives each step's gap and the worst leaves.

    The change is taken over the entries whose reference gradient is not
    nought: at or above NOUGHT of the median leaf's root-mean-square
    gradient.  A leaf all of whose entries are nought is left out whole;
    a packed leaf keeps its live parts (the key's third of an attention's
    packed input bias is nought under softmax, its query and value thirds
    are not)."""
    names = sorted(ref['grad'])
    weights = dict(weights, loss=1.0)
    steps = [_step_gap(a, r, weights)
             for a, r in zip(prog['loss'], ref['loss'])]
    if len(prog['loss']) != len(ref['loss']):
        steps = [math.inf] * len(ref['loss'])
    loss_gap, later_loss_gap = steps[0], max(steps[1:])
    g_prog, g_ref = _norms(prog['grad']), _norms(ref['grad'])
    worst_grad, grad_leaf = _worst(g_prog, g_ref, names)
    grad_gap = _median(_gaps(g_prog, g_ref, names).values())
    rms = _median([g_ref[n] / math.sqrt(ref['grad'][n].numel())
                   for n in names])
    live = {n: ref['grad'][n].abs() >= NOUGHT * rms for n in names}
    moved = [n for n in names if bool(live[n].any())]
    d_prog = _norms({n: ((prog['params'][n].to(params0[n]) - params0[n])
                         * live[n].to(params0[n].device)) for n in moved})
    d_ref = _norms({n: ((ref['params'][n].to(params0[n]) - params0[n])
                        * live[n].to(params0[n].device)) for n in moved})
    change_gap, change_leaf = _worst(d_prog, d_ref, moved)
    if detail is not None:
        detail.update(step_gaps=steps, worst_grad=worst_grad,
                      grad_leaf=grad_leaf, change_leaf=change_leaf,
                      left_out=sum(int((~live[n]).sum()) for n in names))
    out = {'loss_gap': loss_gap, 'later_loss_gap': later_loss_gap,
           'grad_gap': grad_gap, 'change_gap': change_gap}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}


def judge(values, limits):
    """(correct, checks): every number that has a limit at or under it,
    none missing or not finite; checks is {name: {'value', 'limit'}}."""
    checks = {k: {'value': values.get(k, math.inf), 'limit': lim}
              for k, lim in limits.items()}
    ok = all(math.isfinite(c['value']) and c['value'] <= c['limit']
             for c in checks.values())
    return ok, checks


def program_grad(optimizer, model, beta1):
    """name -> the first gradient as the optimizer got it, from its first
    moment after one step: m = (1 - beta1) g."""
    out = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        if 'exp_avg' not in st:
            raise RuntimeError(f'no optimizer state for {name}')
        out[name] = (st['exp_avg'].detach().double() / (1.0 - beta1)).float()
    return out


def snapshot(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}
