"""Model FLOPs of one vid_dcgan_flagship training step: one D update and
`gen_updates` G updates (benchmark/reference/vid_dcgan_flagship.py says
what each computes). Counted from the configuration's shapes alone, so a
packed or otherwise reshaped implementation of a layer counts the same.

D update: the frozen image D's tap forward on the real frames; the vid-G,
frozen image G and tap forwards on the fake ones; the vid-D on both, with
weight gradients and with input gradients above its first layer (its
input is data to the D update). G update: the vid-G with weight
gradients and input gradients above its first layer (its input is z);
the image G, the tap and the vid-D forward with input gradients only
(they are frozen, or not trained by G).
"""

from __future__ import annotations

from typing import Dict

from benchmark.flops._count import conv, deconv, matmul, passes


def _nets(cfg: Dict, batch: int) -> Dict[str, list]:
    """Each net's layers, first to last, as forward FLOPs a step's batch."""
    img = cfg["image_gan"]
    t, s = cfg["vid_length"], img["output_size"]
    n = batch * t
    gf, df, c, h = img["gf_dim"], img["df_dim"], img["c_dim"], \
        cfg["hidden_dim"]
    f = cfg["d_filters"]
    vid_g = [matmul(n, cfg["z_input_size"] + 1, h), matmul(n, h, h),
             matmul(n, h, h), matmul(n, h, cfg["z_output_size"])]
    chans = [gf * 8, gf * 4, gf * 2, gf, c]
    img_g = [matmul(n, img["z_dim"], gf * 8 * (s // 16) ** 2)] + [
        deconv(n * (s // 16 * 2 ** i) ** 2, 5, chans[i], chans[i + 1])
        for i in range(4)]
    chans = [c, df, df * 2, df * 4]
    tap = [conv(n * (s // 2 ** (i + 1)) ** 2, 5, chans[i], chans[i + 1])
           for i in range(3)]
    vid_d, dt, hw, c_in = [], t, s // 8, df * 4
    for _ in range(3):
        dt, hw = (dt + 1) // 2, (hw + 1) // 2
        vid_d.append(conv(batch * dt * hw * hw, 3, c_in, f, nd=3))
        c_in = f
    vid_d.append(matmul(batch, dt * hw * hw * f, 1))
    return {"vid_g": vid_g, "img_g": img_g, "tap": tap, "vid_d": vid_d}


def _run(layers, first_input_grad: bool, input_grad: bool,
         weight_grad: bool) -> float:
    return sum(passes(fl, input_grad and (i > 0 or first_input_grad),
                      weight_grad) for i, fl in enumerate(layers))


def step_flops(cfg: Dict, batch: int) -> float:
    nets = _nets(cfg, batch)
    fwd = lambda name: _run(nets[name], False, False, False)
    d_update = (fwd("tap") + fwd("vid_g") + fwd("img_g") + fwd("tap")
                + 2 * _run(nets["vid_d"], False, True, True))
    g_update = (_run(nets["vid_g"], False, True, True)
                + _run(nets["img_g"], True, True, False)
                + _run(nets["tap"], True, True, False)
                + _run(nets["vid_d"], True, True, False))
    return cfg["disc_updates"] * d_update + cfg["gen_updates"] * g_update


def window_flops(cfg: Dict, traffic, run: Dict) -> float:
    """Model FLOPs of a closed-loop window: its steps at the traffic's
    batch."""
    return step_flops(cfg, traffic.batch) * run["steps"]
