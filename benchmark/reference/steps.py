"""Plain references of the first training steps of MoCo v2 (ResNet-50, a
queue of negatives, SGD) and MoCo v3 (ViT-B/16, the symmetric loss with a
predictor, AdamW), from the same seeded weights and images as the program
under test.

The inputs: image `index` of the synthetic set is
`np.random.default_rng(index).integers(0, 256, (size, size, 3), uint8)`;
epoch `e` visits the indices in the order
`np.random.default_rng((seed, e)).permutation(rows)`, a batch at a time;
each batch's two views are `augment.two_views`.

A step, as the MoCo v2 and v3 papers and their code define it:

1. EMA of the key encoder's parameters toward the query encoder's, at
   m(step): MoCo v2 a constant, v3 `1 - (1 - m) (1 + cos(pi step / T)) / 2`
   over the T steps of training;
2. the key encoder on the key views (v3: on both views), BatchNorm from
   the batch, outputs normalized to unit length;
3. the query encoder on the query views (v3: both views, then the
   predictor);
4. v2: cross-entropy of [q.k, q.queue] / tau with the positive first;
   v3: ctr(q1, k2) + ctr(q2, k1), ctr = 2 tau CE(q k^T / tau, diagonal);
5. the gradient and the optimizer's update at lr(step): the per-epoch
   cosine schedule with a linear warm-up; v2 SGD (momentum, weight decay
   added to the gradient), v3 AdamW (decoupled weight decay on kernels
   and the class token only, the patch embedding frozen);
6. v2: the keys written into the queue at its pointer.

Everything runs in float32 with TF32 off (the caller sets the flags), or
through `nets.Precision("fp8")` for the control. The ViT's forward and
backward run in row chunks, cut at the backbone's output, so that a
batch of 512 views fits beside nothing else.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import nets

V3_CHUNK = 64  # ViT rows per chunk of the reference's forward and backward


def synthetic_batch(seed: int, epoch: int, step: int, batch: int, rows: int,
                    size: int) -> np.ndarray:
    order = np.random.default_rng((seed, epoch)).permutation(rows)
    idx = order[step * batch:(step + 1) * batch]
    return np.stack([np.random.default_rng(int(i)).integers(0, 256, (size, size, 3), np.uint8)
                     for i in idx])


def lr_at(step: int, optim: dict, steps_per_epoch: int) -> float:
    base = optim["lr"]
    warm = optim.get("warmup_epochs", 0) * steps_per_epoch
    if step < warm:
        return base * (step + 1) / warm
    epoch = step // steps_per_epoch
    if optim.get("cos", False):
        return base * 0.5 * (1.0 + math.cos(math.pi * epoch / optim["epochs"]))
    return base * 0.1 ** sum(epoch >= m for m in optim.get("schedule", ()))


def ema_at(step: int, moco: dict, total_steps: int) -> float:
    m = moco["momentum"]
    if not moco.get("momentum_cos", False):
        return m
    frac = min(max(step / total_steps, 0.0), 1.0)
    return 1.0 - (1.0 - m) * 0.5 * (1.0 + math.cos(math.pi * frac))


def unit(x):
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-12)


class Trainer:
    """The reference's state and its steps. `weights`: name -> tensor
    (`weights.py`), read, never written. `cfg`: the configuration file's
    dict. `kinds`: name -> the spec's kind (which leaves decay)."""

    def __init__(self, cfg: dict, weights: dict, kinds: dict, queue, steps_per_epoch: int,
                 device, prec: nets.Precision = nets.FP32, half_batch: bool = False):
        self.cfg, self.moco, self.optim = cfg, cfg["moco"], cfg["optim"]
        self.v3 = bool(self.moco.get("v3", False))
        self.prec, self.half_batch = prec, half_batch
        self.steps_per_epoch = steps_per_epoch
        self.total = self.optim["epochs"] * steps_per_epoch
        self.q = {n: t.to(device=device, dtype=torch.float32).clone() for n, t in weights.items()}
        self.k = {n: t.clone() for n, t in self.q.items() if not n.startswith("predictor.")}
        self.kinds = kinds
        frozen = (("backbone.patch_embed.",)
                  if self.v3 and self.moco.get("freeze_patch_embed", True) else ())
        self.params = [n for n, kd in kinds.items() if kd not in ("buffer",)
                       and not n.endswith(("running_mean", "running_var"))]
        self.trained = [n for n in self.params if not n.startswith(frozen)]
        self.queue = None if queue is None else queue.to(device=device, dtype=torch.float32).clone()
        self.ptr = 0
        self.opt: dict = {}
        self.step_count = 0
        self.first_grads: dict = {}
        self.losses: list = []
        self.keys: list = []

    # -- the encoders --------------------------------------------------------

    def _resnet(self, P, x):
        return nets.resnet50_v2(P, x, train=True, prec=self.prec,
                                num_filters=self.cfg.get("num_filters", 64))

    def _vit_feats(self, P, x):
        return nets.vit_features(P, x, self.prec, self.cfg["vit"])

    def _projector(self, P, f):
        return nets.mlp_head(P, "head", f, 3, True, True, self.prec)

    def _predictor(self, P, z):
        return nets.mlp_head(P, "predictor", z, 2, True, True, self.prec)

    # -- one step --------------------------------------------------------

    def step(self, im_q: torch.Tensor, im_k: torch.Tensor) -> float:
        s = self.step_count
        if self.half_batch:  # a fault: half the batch left out, the mean over the rest
            h = im_q.shape[0] // 2
            im_q, im_k = im_q[:h], im_k[:h]
        m = ema_at(s, self.moco, self.total)
        for n in self.params:
            if n in self.k:
                self.k[n] = self.k[n] * m + self.q[n] * (1.0 - m)
        loss, grads = (self._v3_loss if self.v3 else self._v2_loss)(im_q, im_k)
        if s == 0:
            self.first_grads = {n: g.detach().clone() for n, g in grads.items()}
        self._update(grads, lr_at(s, self.optim, self.steps_per_epoch))
        self.step_count += 1
        self.losses.append(float(loss))
        return float(loss)

    def _v2_loss(self, im_q, im_k):
        with torch.no_grad():
            k = unit(self._resnet(self.k, im_k))
        leaves = {n: self.q[n].detach().requires_grad_() for n in self.trained}
        P = {**self.q, **leaves}
        q = unit(self._resnet(P, im_q))
        t = self.moco["temperature"]
        logits = torch.cat([(q * k).sum(-1, keepdim=True),
                            self.prec.matmul(q, self.queue.t())], 1) / t
        loss = (torch.logsumexp(logits, 1) - logits[:, 0]).mean()
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        n = k.shape[0]
        K = self.queue.shape[0]
        self.queue[self.ptr:self.ptr + n] = k
        self.keys.append(k.clone())
        self.ptr = (self.ptr + n) % K
        return loss.detach(), grads

    def _chunks(self, n):
        return [slice(i, min(i + V3_CHUNK, n)) for i in range(0, n, V3_CHUNK)]

    def _v3_loss(self, im_q, im_k):
        x = torch.cat([im_q, im_k])
        n = x.shape[0]
        with torch.no_grad():
            fk = torch.cat([self._vit_feats(self.k, x[c]) for c in self._chunks(n)])
            k1, k2 = unit(self._projector(self.k, fk)).chunk(2)
            fq = torch.cat([self._vit_feats(self.q, x[c]) for c in self._chunks(n)])
        leaves = {name: self.q[name].detach().requires_grad_() for name in self.trained}
        P = {**self.q, **leaves}
        fq = fq.requires_grad_()
        q1, q2 = unit(self._predictor(P, self._projector(P, fq))).chunk(2)
        t = self.moco["temperature"]
        labels = torch.arange(q1.shape[0], device=x.device)

        def ctr(a, b):
            logits = self.prec.matmul(a, b.t()) / t
            return 2 * t * (torch.logsumexp(logits, 1) - logits[labels, labels]).mean()

        loss = ctr(q1, k2) + ctr(q2, k1)
        head = [nm for nm in leaves if not nm.startswith("backbone.")]
        back = [nm for nm in leaves if nm.startswith("backbone.")]
        g_all = torch.autograd.grad(loss, [leaves[nm] for nm in head] + [fq])
        grads = dict(zip(head, g_all[:-1]))
        g_feat = g_all[-1]
        acc = {nm: torch.zeros_like(leaves[nm]) for nm in back}
        for c in self._chunks(n):
            bl = {nm: self.q[nm].detach().requires_grad_() for nm in back}
            f = self._vit_feats({**self.q, **bl}, x[c])
            gs = torch.autograd.grad(f, list(bl.values()), grad_outputs=g_feat[c])
            for nm, g in zip(back, gs):
                acc[nm] += g
        grads.update(acc)
        return loss.detach(), grads

    def _update(self, grads: dict, lr: float) -> None:
        o = self.optim
        wd = o["weight_decay"]
        with torch.no_grad():
            if o["optimizer"] == "sgd":
                for n, g in grads.items():
                    d = g + wd * self.q[n]
                    buf = self.opt.get(n)
                    buf = d.clone() if buf is None else buf * o["momentum"] + d
                    self.opt[n] = buf
                    self.q[n] = self.q[n] - lr * buf
                return
            if o["optimizer"] != "adamw":
                raise ValueError(f"the reference has no {o['optimizer']!r}")
            b1, b2, eps = 0.9, 0.999, 1e-8
            t = self.step_count + 1
            for n, g in grads.items():
                m, v = self.opt.get(n, (torch.zeros_like(g), torch.zeros_like(g)))
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * g * g
                self.opt[n] = (m, v)
                p = self.q[n]
                if self.kinds[n] in ("conv", "linear", "token"):
                    p = p * (1 - lr * wd)
                denom = (v.sqrt() / math.sqrt(1 - b2 ** t)) + eps
                self.q[n] = p - (lr / (1 - b1 ** t)) * m / denom
