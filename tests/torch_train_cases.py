"""Helpers for holding a VV or VP train step on two devices, or in two
frameworks, against each other, and the model variants (the ensemble's
move and step, the Bayesian net's steps) on two devices (no JAX here:
chip_smoke.py imports it).

A pre-activation within float32 rounding of zero may fall on either side
of its ReLU in two float32 computations; its unit's gradient then differs
as a whole, which no tolerance on the sums covers. `min_nonzero_
preactivation` finds the nearest one (in float64), so a comparison with
another framework can pick a minibatch that holds none. Two devices can
be asked directly: `agreeing_minibatch` picks a minibatch on which both
put every ReLU input on the same side of zero.
"""

import copy

import torch
import torch.nn.functional as F

from tetris_mcts_tpu_torch.models.nets import group_norm, tf32_off


@torch.no_grad()
def min_nonzero_preactivation(net, states):
    """The smallest non-zero |pre-activation| of the VV net's four ReLUs
    on states (n, 1, 20, 10), computed in float64 on the CPU."""
    net = copy.deepcopy(net).cpu().double()
    x, found = states.detach().cpu().double(), []
    for c in (net.conv1, net.conv2, net.conv3):
        z = F.conv2d(x, c.weight, c.bias)
        found.append(z.abs()[z != 0].min())
        x = F.relu(z)
    z = F.linear(x.flatten(1), net.fc1.weight, net.fc1.bias)
    found.append(z.abs()[z != 0].min())
    return float(min(found))


@torch.no_grad()
def relu_masks(net, states):
    """Which inputs of the net's ReLUs are positive on states (n, 1, 20,
    10): the VV net's four, the Q nets' three, or the VP net's four (after
    each GroupNorm, and the two 128-unit FCs), computed as the float32
    forward computes them (TF32 off) on the net's own device; returned on
    the CPU."""
    x, masks = states.to(net.conv1.weight.device, torch.float32), []
    with tf32_off():
        if hasattr(net, "norm1"):  # VPNet
            for c, n in ((net.conv1, net.norm1), (net.conv2, net.norm2)):
                z = group_norm(F.conv2d(x, c.weight, c.bias), n.weight, n.bias)
                masks.append(z > 0)
                x = F.relu(z)
            x = x.flatten(1)
            masks += [F.linear(x, fc.weight, fc.bias) > 0 for fc in (net.fc_v, net.fc_p)]
            return [m.cpu() for m in masks]
        for c in (net.conv1, net.conv2, getattr(net, "conv3", None)):
            if c is not None:
                z = F.conv2d(x, c.weight, c.bias)
                masks.append(z > 0)
                x = F.relu(z)
        z = F.linear(x.flatten(1), net.fc1.weight, net.fc1.bias)
        masks.append(z > 0)
    return [m.cpu() for m in masks]


def agreeing_minibatch(net, other, states, batch, seed=0, tries=64):
    """Row indices (batch,) drawn with replacement from a seeded CPU
    generator: the first draw on whose minibatch `net` and `other` (the
    same weights, on two devices; or lists of such pairs, every pair
    agreeing) put every ReLU input on the same side of zero. Returns
    (indices, draws made, ReLU inputs that crossed over in the draws
    rejected)."""
    pairs = list(zip(net, other)) if isinstance(net, (list, tuple)) else [(net, other)]
    gen = torch.Generator().manual_seed(seed)
    crossed = 0
    for k in range(1, tries + 1):
        idx = torch.randint(0, states.shape[0], (batch,), generator=gen)
        rows = states[idx.to(states.device)]
        n = sum(int((a != b).sum()) for x, y in pairs
                for a, b in zip(relu_masks(x, rows), relu_masks(y, rows)))
        if n == 0:
            return idx, k, crossed
        crossed += n
    raise AssertionError(f"no minibatch of {tries} draws puts every ReLU input on the same "
                         f"side of zero on both devices ({crossed} crossed over)")


def dqn_update_on_two_devices(driver, seed=0):
    """One DQN update of `driver` (its net, target and Adam state, on the
    card) against the same update on the CPU, on a minibatch of the
    driver's ring on which the net puts every ReLU input on the same side of
    zero on both devices. Adam with eps 1e-8 turns a rounding difference in
    a gradient entry near zero into an update of up to its learning rate,
    so the two parts are held apart: the loss and the gradients of each
    device, then Adam on the CPU fed the card's gradients. Returns a dict:
    loss and grads per device ("card", "cpu"), the params after the card's
    step and after the CPU's step on those gradients, and the minibatch
    draws made. The card driver's net takes the step."""
    from tetris_mcts_tpu_torch.runtime import dqn as D

    cfg = driver.cfg
    cpu = D.DQNDriver(cfg, device="cpu", log=lambda s: None)
    with torch.no_grad():
        for part in ("net", "target"):
            for a, b in zip(getattr(cpu, part).parameters(), getattr(driver, part).parameters()):
                a.copy_(b.cpu())
    mu, nu, count = driver.opt.state()
    cpu.opt.load([m.cpu() for m in mu], [v.cpu() for v in nu], count)
    rows = [a[:int(driver.replay.count)].cpu() for a in driver.replay.arrays()]
    idx, draws, _ = agreeing_minibatch(cpu.net, driver.net, D._imgs(rows[0]),
                                       cfg.train_batch, seed)
    out = {"draws": draws}
    for key, d in (("card", driver), ("cpu", cpu)):
        batch = tuple(a[idx].to(d.device) for a in rows)
        with tf32_off():
            loss = D.dqn_loss(d.net, d.target, batch, cfg)
            grads = torch.autograd.grad(loss, list(d.net.parameters()))
        out[key] = (loss.detach(), grads)
    grads = out["card"][1]
    driver.opt.step(grads)
    cpu.opt.step([g.cpu() for g in grads])
    out["params"] = ([p.detach() for p in driver.net.parameters()],
                     [p.detach() for p in cpu.net.parameters()])
    return out


def train_columns(n=512, seed=7, device="cpu"):
    """Seeded VV training columns (states (n, 1, 20, 10), value, variance,
    weight normalised to mean 1) on `device`."""
    import numpy as np

    rng = np.random.RandomState(seed)
    w = rng.uniform(1, 5, n).astype(np.float32)
    cols = [rng.randint(-1, 2, (n, 1, 20, 10)).astype(np.float32),
            rng.uniform(0, 50, n).astype(np.float32), rng.uniform(0, 30, n).astype(np.float32),
            w / w.mean()]
    return [torch.as_tensor(c, device=device) for c in cols]


def ensemble_step_on_two_devices(model, cols, batch, seed=0):
    """One step of the ensemble `model` (on the card) against a CPU copy
    (params, Yogi state, bounds), member k on a minibatch on which its net
    puts every ReLU input on the same side of zero on both devices, with
    PyTorch's TF32 switches on around it (the step pins them off). Returns
    {"card"/"cpu": (member losses, grads)}, then both models' params after
    their own Yogi steps ("params"), and the draws each member's minibatch
    took ("draws"). The card model takes the step."""
    from tetris_mcts_tpu_torch.train.ensemble import EnsembleVVModel

    cpu = EnsembleVVModel(model.n_models, device="cpu")
    cpu.load_state({n: p.detach().cpu() for n, p in model.params.items()},
                   model.ubound.cpu(), model.lbound.cpu())
    mu, nu, count = model.opt.state()
    cpu.opt.load([m.cpu() for m in mu], [v.cpu() for v in nu], count)
    ccols = [c.cpu() for c in cols]
    picks = [agreeing_minibatch(cpu.member_net(k), model.member_net(k), ccols[0], batch,
                                seed + k) for k in range(model.n_models)]
    idx = torch.stack([p[0] for p in picks])
    out = {"draws": [p[1] for p in picks]}
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for key, m, c in (("card", model, cols), ("cpu", cpu, ccols)):
            i = idx.to(m.device)
            loss, _, grads = m.loss_and_grads(tuple(d[i] for d in c))
            out[key] = (loss, grads)
            m.train_step(c, i)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    out["params"] = ([model.params[n].detach() for n in model.names],
                     [cpu.params[n].detach() for n in cpu.names])
    return out


def ensemble_move_on_two_devices(K=3, seed=0, moves=2, card_device="cuda"):
    """`moves` lp moves (B=4, 8 sims, pools 256, table 512, depth 16) with a
    K-member ensemble as the net on the card, then on the CPU with a copy
    of its weights, on the same fixed planes. The CPU's search is fed the
    card's net outputs (so the two searches see the same values), and the
    CPU ensemble's own outputs on the same boards are held against the
    card's within the VV net's bounds (rtol 1e-4; atol 1e-3 value, 1e-2
    variance). Returns ({"value"/"variance": largest |card - cpu| of the
    nets}, card (actions, trees, envs), cpu (actions, trees, envs), the
    number of net calls)."""
    import numpy as np

    from tetris_mcts_tpu_torch.search import mcts
    from tetris_mcts_tpu_torch.search import tree as T
    from tetris_mcts_tpu_torch.train.ensemble import EnsembleVVModel

    tcfg = T.TreeConfig(max_nodes=256, max_obs=256, table_size=512, max_depth=16)
    scfg = mcts.SearchConfig(tree=tcfg, sims=8)
    card = EnsembleVVModel(K, seed=seed, device=card_device)
    cpu = EnsembleVVModel(K, seed=seed, device="cpu")
    cpu.load_state({n: p.detach().cpu() for n, p in card.params.items()},
                   card.ubound.cpu(), card.lbound.cpu())
    rng = np.random.RandomState(seed)
    planes = [torch.as_tensor(-np.log(rng.exponential(size=(4, 16, 7))), dtype=torch.float32)
              for _ in range(moves * scfg.sims)]
    zeros = torch.zeros(4, 16, 7)
    calls, err = [], {"value": 0.0, "variance": 0.0}

    def on_card(imgs):
        v, var = card.apply_fn()(imgs)
        calls.append((imgs.cpu(), v.cpu(), var.cpu()))
        return v, var

    fed = iter(calls)

    def on_cpu(imgs):
        want_imgs, v, var = next(fed)
        if not torch.equal(imgs, want_imgs):
            raise AssertionError("ensemble move: the CPU's search evaluated other boards")
        mine = cpu.apply_fn()(imgs)
        for k, a, b, atol in (("value", mine[0], v, 1e-3), ("variance", mine[1], var, 1e-2)):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=atol, msg=f"ensemble {k}")
            err[k] = max(err[k], float((a - b).abs().max()))
        return v, var

    results = {}
    for dev, net in ((card_device, on_card), ("cpu", on_cpu)):
        feed = iter(planes)
        src = lambda B, D, dev=dev: (next(feed).to(dev), zeros.to(dev))
        move = mcts.make_move_fn(mcts.nn_child_evaluator(net), scfg, src)
        trees, envs = mcts.init_batch(7, 4, scfg, device=dev)
        acts = []
        for _ in range(moves):
            envs, st = move(trees, envs)
            acts.append(st.action)
        results[net] = (torch.stack(acts), trees, envs)
    return err, results[on_card], results[on_cpu], len(calls)


def bbb_step_in_parts(model, cols, batch, seed=0):
    """One step of the Bayesian net `model` (on the card) against a CPU copy
    (mu, rho, the Adam state), held in parts. The eps are drawn once on the
    CPU (seeded) and used on both devices; the minibatch is one on which
    every draw's net puts every ReLU input on the same side of zero on both
    devices. Adam: the loss and the gradients of mu and rho per device, then
    both models' Adam steps fed the card's gradients. BGD: the draws' data
    losses and gradients per device, then both models' closed-form updates
    fed the card's gradients. Returns {"card"/"cpu": (loss(es), grads),
    "params": (the card's mu + rho, the CPU's), "draws": minibatch draws}."""
    from tetris_mcts_tpu_torch.models.nets import VVNet
    from tetris_mcts_tpu_torch.train.bayesian import BBBVVModel, softplus

    cpu = BBBVVModel(mc_iters=model.mc_iters, device="cpu", method=model.method)
    cpu.load_state({n: p.detach().cpu() for n, p in model.mu.items()},
                   {n: p.detach().cpu() for n, p in model.rho.items()})
    cpu.ubound = model.ubound.cpu()
    mu, nu, count = model.opt.state()
    cpu.opt.load([m.cpu() for m in mu], [v.cpu() for v in nu], count)
    gen = torch.Generator().manual_seed(seed)
    eps = {n: torch.randn((model.mc_iters, *p.shape), generator=gen)
           for n, p in cpu.mu.items()}
    geps = {n: e.to(model.device) for n, e in eps.items()}

    def draw_nets(m, e):
        nets = []
        with torch.no_grad():
            for d in range(m.mc_iters):
                net = VVNet().to(m.device)
                net.load_state_dict({n: m.mu[n] + softplus(m.rho[n]) * e[n][d]
                                     for n in m.names})
                nets.append(net)
        return nets

    ccols = [c.cpu() for c in cols]
    idx, draws, _ = agreeing_minibatch(draw_nets(cpu, eps), draw_nets(model, geps), ccols[0],
                                       batch, seed)
    out = {"draws": draws}
    for key, m, c, e in (("card", model, cols, geps), ("cpu", cpu, ccols, eps)):
        b = tuple(d[idx.to(m.device)] for d in c)
        if m.method == "adam":
            out[key] = m.adam_loss_and_grads(b, e)
        else:
            losses, grads = m.draw_grads(b, e)
            out[key] = (losses, [grads[n] for n in m.names])
    grads = out["card"][1]
    if model.method == "adam":
        model.opt.step(grads)
        cpu.opt.step([g.cpu() for g in grads])
    else:
        model.bgd_update(dict(zip(model.names, grads)), geps)
        cpu.bgd_update({n: g.cpu() for n, g in zip(cpu.names, grads)}, eps)
    out["params"] = tuple([p.detach() for part in (m.mu, m.rho) for p in part.values()]
                          for m in (model, cpu))
    return out
