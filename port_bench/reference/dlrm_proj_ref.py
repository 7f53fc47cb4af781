"""The plain reference of torchrec's DLRM_Projection: the forward, the loss
and its gradients, and row-wise sparse Adagrad, in plain PyTorch and float32
with TF32 off. It imports nothing of the program and takes nothing the
program made: the benchmark hands it the inputs it handed the program (the
dense parameters and the table rows it drew, the batches), and it works out
again which rows a batch touches, each hit's row, the pooled sums and the
update of each touched row.

The model (torchrec/models/dlrm.py, DLRM_Projection with
InteractionProjectionArch; torchrec_dlrm/dlrm_main.py:618-635), D the
embedding dim, F = 1 + the tables:
  x = bottom MLP(dense)                         ReLU after every layer
  c = flatten(cat(x, pooled_0, ..., pooled_25))  [B, F D]
  Y = branch1(c).reshape(B, F1, D)              torchrec's MLP: ReLU after
  Z = branch2(c).reshape(B, D, F2)              every layer, the last too
  logit = top MLP(cat(x, flatten(bmm(Y, Z))))   ReLU after every layer but
  loss = mean over the batch of BCE with logits the last
with F_i = branch i's last size / D; Z is read [D, F2] as it comes, not
transposed. A layer is {"w": [n_in, n_out], "b": [n_out]}; the tree is
{"bot", "proj_branch1", "proj_branch2", "top"}, each a list of layers.

The weights are the benchmark's, drawn as torchrec draws them (towers and
branches as nn.Linear does, W and b ~ U(-1/sqrt(n_in), 1/sqrt(n_in)); the
tables U(-sqrt(1/n), sqrt(1/n)), EmbeddingBagConfig's default). The one
departure from torchrec: the dense leaves take element-wise Adagrad with
the tables' lr and eps, as the port's trainer does, where torchrec_dlrm
hands them to its own dense optimizer.

Optimizer (row-wise sparse Adagrad, torchrec's ROWWISE_ADAGRAD): a dense
leaf keeps an element-wise accumulator, a += g^2, p -= lr g / (sqrt(a) +
eps); a table row keeps one, a += mean over the row of G^2, row -= lr G /
(sqrt(a) + eps), where G sums the pooled gradient of every bag that hits
the row.

`quant` selects the arithmetic: "fp32" is the reference; "fp8" is the
control, the same steps with every product's operands (the bmm's too) and
every stored table row rounded to float8 e4m3 with a per-tensor scale (the
step below the configuration's bfloat16), which the comparison has to fail.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

FP8_MAX = 448.0
PARTS = ("bot", "proj_branch1", "proj_branch2", "top")


def exact_matmuls() -> None:
    """float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with the scale that maps max |x| to the
    format's largest value, returned in float32."""
    x = x.detach()
    s = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _q(quant: str):
    """The operand rounding of `quant`: identity for fp32; for fp8 the
    rounded value forward and the identity's gradient backward."""
    if quant == "fp32":
        return lambda x: x
    if quant == "fp8":
        return lambda x: x + (fp8_round(x) - x.detach())
    raise ValueError(f"quant {quant!r}")


def mlp(layers: Sequence[dict], x: torch.Tensor, q, last_linear=False):
    for i, layer in enumerate(layers):
        x = q(x) @ q(layer["w"]) + layer["b"]
        if not (last_linear and i == len(layers) - 1):
            x = torch.relu(x)
    return x


def logits(dense_params: dict, dense: torch.Tensor, pooled: torch.Tensor,
           quant: str = "fp32") -> torch.Tensor:
    """[B, 1] logits from dense features [B, 13] and pooled [B, T, D]."""
    q = _q(quant)
    x = mlp(dense_params["bot"], dense, q)
    b, d = x.shape
    c = torch.cat([x, pooled.reshape(b, -1)], dim=1)
    y = mlp(dense_params["proj_branch1"], c, q).reshape(b, -1, d)
    z = mlp(dense_params["proj_branch2"], c, q).reshape(b, d, -1)
    inter = torch.bmm(q(y), q(z)).reshape(b, -1)
    return mlp(dense_params["top"], torch.cat([x, inter], dim=1), q,
               last_linear=True)


def bce(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.logaddexp(z, torch.zeros_like(z)) - labels * z).mean()


def leaves(tree: dict) -> Dict[str, torch.Tensor]:
    """The dense leaves by name: bot.0.w, proj_branch2.1.b, top.4.b, ..."""
    return {f"{k}.{i}.{n}": t for k in PARTS
            for i, layer in enumerate(tree[k]) for n, t in layer.items()}


def touched(idx_tables: Sequence[torch.Tensor]):
    """Per table: the distinct rows that a list of [B, h] index blocks
    hits, sorted, and each block's hits as positions among them."""
    rows = torch.unique(torch.cat([i.reshape(-1) for i in idx_tables]))
    return rows, [torch.searchsorted(rows, i) for i in idx_tables]


def train(tables0: List[torch.Tensor], local: List[List[torch.Tensor]],
          dense0: dict, dense: List[torch.Tensor],
          labels: List[torch.Tensor], lr: float, eps: float,
          quant: str = "fp32") -> dict:
    """len(dense) steps of the model from tables0 (table t's touched rows,
    [u_t, D] float32) and dense0; local[k][t] is step k's [B, h_t] hits of
    table t as positions among its touched rows. Returns each step's loss,
    the first step's probabilities, the first gradient's norm and the
    change's norm after the last step, by leaf ("emb.<t>" for table t)."""
    store = fp8_round if quant == "fp8" else (lambda x: x)
    w = [store(t.float()) for t in tables0]
    acc = [torch.zeros(t.shape[0], device=t.device) for t in tables0]
    p = {k: v.detach().clone().float() for k, v in leaves(dense0).items()}
    p0 = {k: v.clone() for k, v in p.items()}
    w0 = [t.clone() for t in w]
    pacc = {k: torch.zeros_like(v) for k, v in p.items()}
    out = {"loss": [], "probs": None, "grad": {}, "change": {}}
    for k in range(len(dense)):
        pooled = torch.stack(
            [w[t][local[k][t]].sum(dim=1) for t in range(len(w))], dim=1)
        pooled.requires_grad_()
        tree = {part: [] for part in PARTS}
        req = {n: v.clone().requires_grad_() for n, v in p.items()}
        for name, v in req.items():
            part, i, leaf = name.split(".")
            while len(tree[part]) <= int(i):
                tree[part].append({})
            tree[part][int(i)][leaf] = v
        z = logits(tree, dense[k], pooled, quant)
        loss = bce(z, labels[k])
        names = list(req)
        *g, dly = torch.autograd.grad(loss, [req[n] for n in names] + [pooled])
        out["loss"].append(float(loss.detach()))
        with torch.no_grad():
            if k == 0:
                out["probs"] = torch.sigmoid(z).detach()
            for n, gn in zip(names, g):
                if k == 0:
                    out["grad"][n] = float(torch.linalg.vector_norm(gn))
                pacc[n] += gn * gn
                p[n] -= (lr * gn) / (torch.sqrt(pacc[n]) + eps)
            for t in range(len(w)):
                h = local[k][t].shape[1]
                gsum = torch.zeros_like(w[t]).index_add_(
                    0, local[k][t].reshape(-1),
                    dly[:, t, :].repeat_interleave(h, dim=0))
                if k == 0:
                    out["grad"][f"emb.{t}"] = float(
                        torch.linalg.vector_norm(gsum))
                acc[t] += (gsum * gsum).mean(dim=1)
                w[t] = store(w[t] - (lr * gsum)
                             / (torch.sqrt(acc[t]) + eps)[:, None])
    with torch.no_grad():
        for n in p:
            out["change"][n] = float(torch.linalg.vector_norm(p[n] - p0[n]))
        for t in range(len(w)):
            out["change"][f"emb.{t}"] = float(
                torch.linalg.vector_norm(w[t] - w0[t]))
    return out
