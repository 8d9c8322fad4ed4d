/* gifgan_tpu in-browser generator: dependency-free forward pass over the
 * "gifgan_tpu.generator/1" JSON weight schema (serve/web_export.py).
 *
 * Replaces the reference's convnet.js path (web/js/app.js:30-60 driving
 * weights exported by utils.py:69-130) with the exact op semantics of
 * gifgan_tpu/ops/nn.py:
 *   linear:   y = zW + b                        (W stored [in][out])
 *   batch_norm (inference): (x-mean)/sqrt(var+eps)*scale + bias, per channel
 *   deconv2d: exact tf.nn.conv2d_transpose SAME stride-2 semantics — the
 *     gradient-of-SAME-conv: dilate by 2, pad (k-1-pl, k-1-pr) with
 *     pl=floor((k-stride)/2), correlate with the spatially-flipped
 *     [h,w,out,in] kernel. Implemented as a scatter over input pixels so
 *     the dilation zeros are never touched.
 * Layout is NHWC row-major throughout, matching numpy's ravel().
 */
"use strict";

function gifganLinear(z, layer) {
  const W = layer.w, b = layer.b;
  const inDim = W.length, outDim = b.length;
  const out = new Float32Array(outDim);
  for (let o = 0; o < outDim; o++) out[o] = b[o];
  for (let i = 0; i < inDim; i++) {
    const zi = z[i], Wi = W[i];
    if (zi === 0) continue;
    for (let o = 0; o < outDim; o++) out[o] += zi * Wi[o];
  }
  return out;
}

function gifganBatchNorm(t, layer) {
  const { data, c } = t;
  const scale = layer.scale, bias = layer.bias;
  const mean = layer.mean, va = layer.var, eps = layer.eps || 1e-5;
  const inv = new Float32Array(c);
  for (let k = 0; k < c; k++) inv[k] = scale[k] / Math.sqrt(va[k] + eps);
  for (let p = 0; p < data.length; p += c)
    for (let k = 0; k < c; k++)
      data[p + k] = (data[p + k] - mean[k]) * inv[k] + bias[k];
  return t;
}

function gifganRelu(t) {
  const d = t.data;
  for (let i = 0; i < d.length; i++) if (d[i] < 0) d[i] = 0;
  return t;
}

function gifganDeconv2d(t, layer) {
  const k = layer.w_shape[0];              // 5
  const OC = layer.w_shape[2], IC = layer.w_shape[3];
  const stride = layer.stride || 2;
  const H = t.h, W = t.w, outH = H * stride, outW = W * stride;
  // pads of the underlying SAME forward conv: total k-stride, low=floor
  const padTotal = Math.max(k - stride, 0);
  const pl = Math.floor(padTotal / 2);
  const top = k - 1 - pl;                   // dilated-input top/left pad
  const w = layer.w, b = layer.b, inD = t.data;
  const out = new Float32Array(outH * outW * OC);
  for (let p = 0; p < out.length; p += OC)
    for (let oc = 0; oc < OC; oc++) out[p + oc] = b[oc];
  for (let i = 0; i < H; i++) {
    for (let j = 0; j < W; j++) {
      const inBase = (i * W + j) * IC;
      for (let a = 0; a < k; a++) {
        const y = stride * i + top - a;
        if (y < 0 || y >= outH) continue;
        for (let bb = 0; bb < k; bb++) {
          const x = stride * j + top - bb;
          if (x < 0 || x >= outW) continue;
          // flipped kernel: wf[a][bb] = w[k-1-a][k-1-bb], layout [h,w,oc,ic]
          const wBase = (((k - 1 - a) * k + (k - 1 - bb)) * OC) * IC;
          const outBase = (y * outW + x) * OC;
          for (let oc = 0; oc < OC; oc++) {
            let acc = 0.0;
            const wRow = wBase + oc * IC;
            for (let ic = 0; ic < IC; ic++)
              acc += inD[inBase + ic] * w[wRow + ic];
            out[outBase + oc] += acc;
          }
        }
      }
    }
  }
  return { data: out, h: outH, w: outW, c: OC };
}

/* model: parsed JSON of the v1 schema; z: Array(z_dim) in [-1, 1].
 * Returns {data: Float32Array in [-1,1] (tanh), h, w, c}. */
function gifganGenerate(model, z) {
  const s16 = model.output_size / 16;
  const layers = {};
  for (const l of model.layers) layers[l.name] = l;
  let h = gifganLinear(z, layers.h0_lin);
  let t = { data: h, h: s16, w: s16, c: model.gf_dim * 8 };
  gifganRelu(gifganBatchNorm(t, layers.bn0));
  for (let i = 1; i <= 3; i++) {
    t = gifganDeconv2d(t, layers["h" + i + "_deconv"]);
    gifganRelu(gifganBatchNorm(t, layers["bn" + i]));
  }
  t = gifganDeconv2d(t, layers.h4_deconv);
  for (let i = 0; i < t.data.length; i++) t.data[i] = Math.tanh(t.data[i]);
  return t;
}

/* Paint a generated tensor ([-1,1], NHWC c=1|3) into a canvas at `scale`. */
function gifganPaint(canvas, t, scale) {
  scale = scale || 2;
  canvas.width = t.w * scale;
  canvas.height = t.h * scale;
  const ctx = canvas.getContext("2d");
  const img = ctx.createImageData(canvas.width, canvas.height);
  for (let y = 0; y < t.h; y++) {
    for (let x = 0; x < t.w; x++) {
      const base = (y * t.w + x) * t.c;
      const r = Math.max(0, Math.min(255, 255 * (t.data[base] + 1) / 2));
      const g = t.c > 1 ? Math.max(0, Math.min(255,
        255 * (t.data[base + 1] + 1) / 2)) : r;
      const b = t.c > 2 ? Math.max(0, Math.min(255,
        255 * (t.data[base + 2] + 1) / 2)) : r;
      for (let dy = 0; dy < scale; dy++) {
        for (let dx = 0; dx < scale; dx++) {
          const p = ((y * scale + dy) * canvas.width + x * scale + dx) * 4;
          img.data[p] = r; img.data[p + 1] = g; img.data[p + 2] = b;
          img.data[p + 3] = 255;
        }
      }
    }
  }
  ctx.putImageData(img, 0, 0);
}

if (typeof module !== "undefined") {  // CommonJS for potential node tests
  module.exports = { gifganGenerate, gifganLinear, gifganBatchNorm,
                     gifganDeconv2d, gifganPaint };
}
