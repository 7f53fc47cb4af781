"""The plain reference of the DLRM-v2 DCN model: the forward, the loss and
its gradients, row-wise sparse Adagrad, and the int8 row decode, in plain
PyTorch and float32 with TF32 off. It imports nothing of the program and
takes nothing the program made: the benchmark hands it the inputs it handed
the program (the dense parameters it drew, the table rows it drew or the
int8 bytes it filled, the batches), and it works out again what the program
derives from them (which rows a batch touches, each hit's row, the pooled
sums, the update of each touched row).

The model (torchrec_dlrm's DLRM_DCN, MLPerf DLRM-v2):
  x  = bottom MLP(dense)            ReLU after every layer
  x0 = [x, pooled_0, ..., pooled_25] pooled_t = sum of table t's bag's rows
  x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l, three low-rank cross layers
  logit = top MLP(x_3)              ReLU after every layer but the last
  loss = mean over the batch of BCE with logits
A tower layer is {"w": [n_in, n_out], "b": [n_out]}; a cross layer
{"v": [r, n], "w": [n, r], "b": [n]}.

Optimizer (row-wise sparse Adagrad, torchrec's ROWWISE_ADAGRAD): a dense
leaf keeps an element-wise accumulator, a += g^2, p -= lr g / (sqrt(a) +
eps); a table row keeps one, a += mean over the row of G^2, row -= lr G /
(sqrt(a) + eps), where G sums the pooled gradient of every bag that hits
the row.

`quant` selects the arithmetic: "fp32" is the reference; "fp8" is the
control, the same steps with every product's operands and every stored
table row rounded to float8 e4m3 with a per-tensor scale (the step below
the configuration's bfloat16), which the comparison has to fail.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

FP8_MAX = 448.0


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


def cross(layers: Sequence[dict], x0: torch.Tensor, q) -> torch.Tensor:
    xl = x0
    for layer in layers:
        low = q(xl) @ q(layer["v"]).t()
        up = q(low) @ q(layer["w"]).t()
        xl = x0 * (up + layer["b"]) + xl
    return xl


def logits(dense_params: dict, dense: torch.Tensor, pooled: torch.Tensor,
           quant: str = "fp32") -> torch.Tensor:
    """[B, 1] logits from dense features [B, D] and pooled [B, T, d]."""
    q = _q(quant)
    x = mlp(dense_params["bot"], dense, q)
    x0 = torch.cat([x, pooled.reshape(pooled.shape[0], -1)], dim=1)
    return mlp(dense_params["top"], cross(dense_params["dcn"], x0, q), q,
               last_linear=True)


def bce(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.logaddexp(z, torch.zeros_like(z)) - labels * z).mean()


def leaves(tree: dict) -> Dict[str, torch.Tensor]:
    """The dense leaves by name: bot.0.w, dcn.2.b, top.4.b, ..."""
    return {f"{k}.{i}.{n}": t for k in ("bot", "dcn", "top")
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
    [u_t, d] float32) and dense0; local[k][t] is step k's [B, h_t] hits of
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
        tree = {"bot": [], "dcn": [], "top": []}
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


def decode_int8_rows(packed: torch.Tensor) -> torch.Tensor:
    """Row-wise int8 rows, [n, d + 8] bytes: d unsigned data bytes, then
    the row's float32 scale and float32 bias -> float32 [n, d] =
    q * scale + bias."""
    sb = packed[:, -8:].contiguous().view(torch.float32)
    return packed[:, :-8].float() * sb[:, :1] + sb[:, 1:]


def serve_probs(packed: torch.Tensor, offsets: Sequence[int],
                idx_tables: Sequence[torch.Tensor], dense_params: dict,
                dense: torch.Tensor, quant: str = "fp32") -> torch.Tensor:
    """Click probabilities [B, 1] of one batch served from int8 rows:
    table t's [B, h] hits are rows offsets[t] + idx of `packed`."""
    pooled = torch.stack(
        [decode_int8_rows(packed[(i.long() + int(o)).reshape(-1)])
         .reshape(i.shape[0], i.shape[1], -1).sum(dim=1)
         for o, i in zip(offsets, idx_tables)], dim=1)
    return torch.sigmoid(logits(dense_params, dense, pooled, quant))
