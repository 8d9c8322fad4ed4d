"""Plain reference of PredNet as published for KITTI (Lotter, Kreiman &
Cox, "Deep Predictive Coding Networks for Video Prediction and
Unsupervised Learning", arXiv:1605.08104, Algorithm 1; Keras code at
github.com/coxlab/prednet prednet.py and kitti_train.py).

Float32 with TF32 off; NHWC activations; nothing of the program imported.
Weights come in as one flat dict "params/prednet/<layer>/<leaf>": per
level l, "lstm<l>" (the convLSTM's gates), "ahat<l>" (A_hat from R) and,
below the top, "up<l>" (A_{l+1} from E_l), each a 3x3 conv "w"
(out, in, 3, 3) and "b".

Per time step, with A_0 the frame in [0, 1] and zero initial states:
- top-down, l = L-1 .. 0: the gates of conv([E_l(t-1), up(R_{l+1}(t)),
  R_l(t-1)]): i, f, o = hard_sigmoid (clip(0.2x + 0.5, 0, 1)), no forget
  bias; g = tanh; C_l = f C_l + i g; R_l = o tanh(C_l); up is the
  nearest-neighbour x2;
- bottom-up, l = 0 .. L-1: A_hat_l = relu(conv(R_l)), at level 0 clipped
  at pixel_max; E_l = [relu(A_l - A_hat_l), relu(A_hat_l - A_l)];
  A_{l+1} = maxpool2x2(relu(conv(E_l))).
The loss ("L_0" in kitti_train.py): sum over t of time weight t (0 at
t = 0, then 1/(nt - 1)) times the sum over levels of layer weight l times
the mean of E_l(t), averaged over the batch. Adam (lr, b1, b2 of the
configuration; eps 1e-8).

Departures from the Keras code, each the same function:
- the error units' channel order, [relu(A - A_hat), relu(A_hat - A)],
  and the order of the LSTM's inputs, [E, up(R above), R], are the
  program's (Keras: [relu(A_hat - A), relu(A - A_hat)] and [R, E, up]):
  permutations of weight rows;
- one fused gate conv, its output channels in the chunks (i, f, o, g),
  replaces Keras's four convs i, f, c, o: the same function;
- Adam's eps sits outside the square root after the bias correction, as
  in the program and the other reference (Keras folds the correction into
  the rate, which scales eps by sqrt(1 - b2^t): against these gradients
  no difference);
- the batch's gradient is summed over blocks of CHUNK clips, so that the
  reference fits beside nothing else at the cell's size: the order of a
  float32 sum.

The harness draws every kernel normal with std 0.02 (benchmark/inputs.py);
`keras_init` maps each draw through the normal's distribution function to
Keras's glorot_uniform, uniform within sqrt(6 / (fan_in + fan_out)), the
fans those of one of Keras's separate convs (the gate conv's out / 4).
Biases are zero, as Keras's.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from benchmark.inputs import STD
from benchmark.reference._plain import (FLOAT32, Adam, Precision, conv,
                                        grads_of, leaf_norms, tf32)

Tensor = torch.Tensor
PREFIX = "params/prednet/"
NET = "prednet/"          # the key prefix of the readings
CHUNK = 16                # clips a block of the reference's batch
SAMPLES = 4096            # predicted values kept of a step (pred_sample)


def _widths(cfg: Dict):
    return list(cfg["stack_sizes"]), list(cfg["r_stack_sizes"])


def param_specs(cfg: Dict) -> Dict[str, tuple]:
    """{flat key: (shape, init)}: every kernel "normal" (`keras_init` makes
    it glorot_uniform), every bias "zeros"."""
    a, r = _widths(cfg)
    n, specs = len(a), {}

    def cnv(key, c_in, c_out):
        specs[f"{PREFIX}{key}/w"] = ((c_out, c_in, 3, 3), "normal")
        specs[f"{PREFIX}{key}/b"] = ((c_out,), "zeros")

    for l in range(n):
        top = r[l + 1] if l + 1 < n else 0
        cnv(f"lstm{l}", 2 * a[l] + top + r[l], 4 * r[l])
        cnv(f"ahat{l}", r[l], a[l])
        if l + 1 < n:
            cnv(f"up{l}", 2 * a[l], a[l + 1])
    return specs


def keras_init(weights: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The harness's weights with each kernel made glorot_uniform: a
    normal draw x of std STD maps to erf(x / (STD sqrt 2)), uniform in
    (-1, 1), times Keras's limit. Biases as they are."""
    out = {}
    for k, v in weights.items():
        if k.endswith("/w"):
            c_out, c_in, kh, kw = v.shape
            fan_out = c_out // 4 if "/lstm" in k else c_out
            limit = math.sqrt(6.0 / (kh * kw * (c_in + fan_out)))
            v = torch.erf(v / (STD * math.sqrt(2.0))) * limit
        out[k] = v
    return out


def _hard_sigmoid(x: Tensor) -> Tensor:
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _up(x: Tensor) -> Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _pool(x: Tensor) -> Tensor:
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def forward(p: Dict[str, Tensor], clips: Tensor, cfg: Dict,
            prec: Precision = FLOAT32):
    """clips (B, T, h, w, c) in [0, 1] -> (predictions A_hat_0 (B, T, h,
    w, c), loss). p: {"<layer>/<leaf>": tensor}."""
    a_w, r_w = _widths(cfg)
    n, (b, t_len, h, w, _) = len(a_w), clips.shape
    layer_w = cfg["layer_loss_weights"]
    zeros = lambda l, ch: clips.new_zeros(b, h >> l, w >> l, ch)
    r = [zeros(l, r_w[l]) for l in range(n)]
    c = [zeros(l, r_w[l]) for l in range(n)]
    e = [zeros(l, 2 * a_w[l]) for l in range(n)]
    cv = lambda name, x: conv(x, p[f"{name}/w"], p[f"{name}/b"], prec,
                              stride=1)
    preds, loss = [], clips.new_zeros(())
    for t in range(t_len):
        for l in reversed(range(n)):
            inputs = [e[l]] + ([_up(r[l + 1])] if l + 1 < n else []) + [r[l]]
            gi, gf, go, gg = cv(f"lstm{l}", torch.cat(inputs, -1)).chunk(
                4, dim=-1)
            c[l] = _hard_sigmoid(gf) * c[l] + _hard_sigmoid(gi) * torch.tanh(
                gg)
            r[l] = _hard_sigmoid(go) * torch.tanh(c[l])
        target = clips[:, t]
        time_w = 0.0 if t == 0 else 1.0 / (t_len - 1)
        for l in range(n):
            a_hat = torch.relu(cv(f"ahat{l}", r[l]))
            if l == 0:
                a_hat = torch.clamp(a_hat, max=cfg["pixel_max"])
                preds.append(a_hat)
            e[l] = torch.cat([torch.relu(target - a_hat),
                              torch.relu(a_hat - target)], -1)
            if layer_w[l]:
                loss = loss + time_w * layer_w[l] * e[l].mean()
            if l + 1 < n:
                target = _pool(torch.relu(cv(f"up{l}", e[l])))
    return torch.stack(preds, 1), loss


def clips_of(corpus_u8: Tensor, ids: Tensor, cfg: Dict) -> Tensor:
    """The batch's clips from the uint8 corpus (N, nt*h*w*c), in [0, 1]:
    (B, nt, h, w, c)."""
    h, w = cfg["frame"]
    rows = corpus_u8[ids.long()].float() / 255.0
    return rows.reshape(ids.shape[0], -1, h, w, cfg["stack_sizes"][0])


def pred_sample(preds: Tensor) -> List[float]:
    """SAMPLES values of a batch's predictions (B, T, h, w, c) at t >= 1,
    at positions drawn from a fixed seed (the same for every batch of one
    shape), in float64: what the check compares of the predicted frames
    (t = 0 predicts from zero states)."""
    flat = preds[:, 1:].reshape(-1)
    at = torch.randint(flat.numel(), (SAMPLES,),
                       generator=torch.Generator().manual_seed(0))
    return flat[at.to(flat.device)].double().tolist()


def loss_and_grads(p: Dict[str, Tensor], clips: Tensor, cfg: Dict,
                   prec: Precision = FLOAT32):
    """(loss, {key: gradient}, predictions) of the batch, summed over
    blocks of CHUNK clips, each block's share weighted by its size."""
    b = clips.shape[0]
    loss, grads, preds = 0.0, None, []
    for i in range(0, b, CHUNK):
        q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
        part = clips[i:i + CHUNK]
        pred, block = forward(q, part, cfg, prec)
        block = block * (part.shape[0] / b)
        g = grads_of(block, q)
        grads = g if grads is None else {k: grads[k] + g[k] for k in g}
        loss += float(block.detach())
        preds.append(pred.detach())
    return loss, grads, torch.cat(preds)


def train_readings(weights: Dict[str, Tensor], corpus_u8: Tensor,
                   steps: List[Dict[str, Tensor]], cfg: Dict,
                   precision: str = "float32") -> Dict:
    """Run the steps (each {"ids": (B,)}) from `weights`, one Adam update
    a step.

    Returns {"loss": [each step's loss], "grad": {"prednet/<key>": norm
    of step 1's gradient}, "change": {"prednet/<key>": norm of its change
    over all the steps}, "pred": pred_sample of step 1's predictions}."""
    prec = Precision(precision)
    first = {k[len(PREFIX):]: v.clone() for k, v in
             keras_init(weights).items() if k.startswith(PREFIX)}
    opt = Adam(first, cfg["learning_rate"], cfg["beta1"], cfg["beta2"],
               cfg["epsilon"])
    p, losses, grad, pred = dict(first), [], {}, None
    with tf32(False):
        for step in steps:
            loss, g, preds = loss_and_grads(
                p, clips_of(corpus_u8, step["ids"], cfg), cfg, prec)
            if not grad:
                grad = {NET + k: v for k, v in leaf_norms(g).items()}
                pred = pred_sample(preds)
            p = {k: v.detach() for k, v in opt.step(p, g).items()}
            losses.append(loss)
    change = {NET + k: v for k, v in leaf_norms(
        {k: p[k] - first[k] for k in first}).items()}
    return {"loss": losses, "grad": grad, "change": change, "pred": pred}
