"""Recurrent agent Q-networks, the double-Q loss, gradient clipping and Adam,
in plain PyTorch.

The published equations (the MARL book codebase's IDQN/QMIX presets):

- each agent's network: x = relu(obs @ W1 + b1); a GRU (torch's gate order
  r, z, n) over time from a zero hidden state; q = h @ W2 + b2. Agent i
  has its own weights (no parameter sharing): every leaf carries a leading
  agent axis.
- double Q: the online network picks a' at t+1, the target network values
  it; IDQN's loss is the per-agent squared TD error summed over agents,
  averaged over the filled (t, b) cells; QMIX mixes the chosen values and
  the target values with its hypernetwork mixer over the concatenated
  observations and takes the team TD error on agent 0's reward.
- the gradient is clipped to a global norm c (kept when the norm is under
  c, else scaled to c) and Adam (b1 0.9, b2 0.999, eps 1e-8) steps.

`precision`: "f32" forms every product in float32 with TF32 off; "tf32"
rounds the inputs of every product to TF32's 10-bit mantissa first, the
next precision down, which is the control that the comparison has to fail.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

F32, TF32 = "f32", "tf32"


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest TF32 value (10 mantissa bits), in float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """`a @ b` with the inputs of every product, the backward's too,
    rounded to TF32, as the tensor cores form a TF32 product."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = tf32_round(a), tf32_round(b)
        ctx.save_for_backward(a, b)
        return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return torch.matmul(g, b.transpose(-1, -2)), torch.matmul(a.transpose(-1, -2), g)


def mm(a, b, precision):
    """Batched product `a @ b` in the given precision."""
    if precision == TF32:
        return _TF32MatMul.apply(a, b)
    return torch.matmul(a, b)


def _round_through(x):
    """TF32 rounding in the forward, the identity in the backward."""
    return x + (tf32_round(x.detach()) - x).detach()


def linear(x, w, b, precision):
    """x (G, R, in), w (G, in, out), b (G, out) -> (G, R, out)."""
    return mm(x, w, precision) + b[:, None, :]


def q_values(p, obs, precision=F32):
    """p: {first: {w, b}, rnn: [{w_ih, w_hh, b_ih, b_hh}], final: {w, b}}
    with a leading agent axis; obs (N, T, B, D) -> q (N, T, B, A), the GRU
    starting from zeros."""
    N, T, B, D = obs.shape
    x = torch.relu(linear(obs.reshape(N, T * B, D), p["first"]["w"], p["first"]["b"], precision))
    x = x.reshape(N, T, B, -1)
    for layer in p["rnn"]:
        H = layer["w_hh"].shape[1]
        gi = linear(x.reshape(N, T * B, -1), layer["w_ih"], layer["b_ih"], precision).reshape(N, T, B, 3 * H)
        h = torch.zeros((N, B, H), dtype=obs.dtype, device=obs.device)
        ys = []
        for t in range(T):
            gh = linear(h, layer["w_hh"], layer["b_hh"], precision)
            r = torch.sigmoid(gi[:, t, :, :H] + gh[..., :H])
            z = torch.sigmoid(gi[:, t, :, H:2 * H] + gh[..., H:2 * H])
            n = torch.tanh(gi[:, t, :, 2 * H:] + r * gh[..., 2 * H:])
            h = (1.0 - z) * n + z * h
            ys.append(h)
        x = torch.stack(ys, dim=1)
    q = linear(x.reshape(N, T * B, -1), p["final"]["w"], p["final"]["b"], precision)
    return q.reshape(N, T, B, -1)


def _mix_linear(layer, x, precision):
    """x (R, in) @ layer w (in, out) + b."""
    return mm(x, layer["w"], precision) + layer["b"]


def _hyper(layers, x, precision):
    x = _mix_linear(layers[0], x, precision)
    if len(layers) == 2:
        x = _mix_linear(layers[1], torch.relu(x), precision)
    return x


def qmix(p, agent_qs, states, precision=F32):
    """The QMIX mixer: agent_qs (N, T, B), states (T, B, S) -> (T, B).
    w1 = |hyper_w_1(s)| (N x E), b1 = hyper_b_1(s), hidden = elu(q @ w1 +
    b1), w_final = |hyper_w_final(s)|, v = V(s) (two layers), q_tot =
    hidden . w_final + v."""
    N, T, B = agent_qs.shape
    x = states.reshape(T * B, -1)
    E = p["hyper_b_1"]["w"].shape[-1]
    qs = agent_qs.reshape(N, T * B).T  # (TB, N)
    w1 = _hyper(p["hyper_w_1"], x, precision).abs().reshape(T * B, N, E)
    b1 = _mix_linear(p["hyper_b_1"], x, precision)
    if precision == TF32:
        qs, w1 = _round_through(qs), _round_through(w1)
    hidden = F.elu(torch.einsum("kn,kne->ke", qs, w1) + b1)
    w_final = _hyper(p["hyper_w_final"], x, precision).abs()
    v = _mix_linear(p["v"][1], torch.relu(_mix_linear(p["v"][0], x, precision)), precision)
    if precision == TF32:
        hidden, w_final = _round_through(hidden), _round_through(w_final)
    return (torch.einsum("ke,ke->k", hidden, w_final) + v[:, 0]).reshape(T, B)


def double_q_loss(params, target, batch, gamma, mixer=None, precision=F32, half_batch=False):
    """The episode double-Q TD loss on a batch: obss (N, T+1, B, D), actions
    (N, T, B), rewards (N, T, B), dones (T+1, B), filled (T, B),
    action_mask (N, T+1, B, A) or None. `params`/`target` hold "critic" and,
    with a mixer, "mixer". `half_batch` is a planted fault: the loss over
    the first half of the rows only."""
    if half_batch:
        half = batch["filled"].shape[-1] // 2
        batch = {k: (None if v is None else (v[..., :half] if k in ("dones", "filled") else v[:, :, :half]))
                 for k, v in batch.items()}
    obss, actions = batch["obss"], batch["actions"]
    N, T1, B, _ = obss.shape
    T = T1 - 1
    q = q_values(params["critic"], obss, precision)
    chosen = q[:, :-1].gather(-1, actions.unsqueeze(-1)).squeeze(-1)  # (N, T, B)
    with torch.no_grad():
        tq = q_values(target["critic"], obss, precision)[:, 1:]
        qn = q.detach()[:, 1:]
        if batch.get("action_mask") is not None:
            valid = batch["action_mask"][:, 1:] > 0
            tq = torch.where(valid, tq, torch.tensor(-1e8, device=tq.device))
            qn = torch.where(valid, qn, torch.tensor(-1e8, device=qn.device))
        target_qs = tq.gather(-1, qn.argmax(-1, keepdim=True)).squeeze(-1)  # (N, T, B)
    not_done = 1.0 - batch["dones"][1:]
    filled = batch["filled"]
    if mixer is None:
        returns = batch["rewards"] + gamma * target_qs * not_done[None]
        loss_tb = ((chosen - returns) ** 2).sum(0)
    else:
        states = obss.permute(1, 2, 0, 3).reshape(T1, B, -1)
        chosen_tot = qmix(params["mixer"], chosen, states[:-1], precision)
        with torch.no_grad():
            target_tot = qmix(target["mixer"], target_qs, states[1:], precision)
        returns = batch["rewards"][0] + gamma * target_tot * not_done
        loss_tb = (chosen_tot - returns) ** 2
    return (loss_tb * filled).sum() / filled.sum().clamp(min=1.0)


class Adam:
    """Global-norm clip to `clip` (over the leaves marked in `clip_mask`),
    then Adam, on a list of leaves."""

    def __init__(self, leaves, lr, clip, clip_mask=None, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.clip, self.b1, self.b2, self.eps = lr, clip, b1, b2, eps
        self.clip_mask = clip_mask or [True] * len(leaves)
        self.mu = [torch.zeros_like(x) for x in leaves]
        self.nu = [torch.zeros_like(x) for x in leaves]
        self.count = 0

    def clipped(self, grads):
        norm = torch.sqrt(sum((g * g).sum() for g, m in zip(grads, self.clip_mask) if m))
        if norm < self.clip:
            return list(grads)
        return [g / norm * self.clip if m else g for g, m in zip(grads, self.clip_mask)]

    @torch.no_grad()
    def step(self, leaves, grads):
        grads = self.clipped(grads)
        self.count += 1
        bc1 = 1.0 - self.b1 ** self.count
        bc2 = 1.0 - self.b2 ** self.count
        for i, (p, g) in enumerate(zip(leaves, grads)):
            self.mu[i] = (1.0 - self.b1) * g + self.b1 * self.mu[i]
            self.nu[i] = (1.0 - self.b2) * g * g + self.b2 * self.nu[i]
            p -= self.lr * (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + self.eps)
        return grads
