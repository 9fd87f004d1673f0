"""The comparison that decides ``correct``: a sample, drawn from the seed,
of the requests the window finished, the longest among them, each run once
through the plain reference in float32 over its prompt and the tokens it
was served. The number compared is the widest gap by which a served token's
logit lies below the reference's best at its position (the tokens are
greedy). The control reads, at the same positions, the gap of the token
that the reference in float8 puts first."""
from __future__ import annotations

import numpy as np
import torch


def choose(cands: list, kinds: dict, seed: int, served_target: int,
           tokens_max: int, inflight: list = ()) -> list:
    """``cands``: (rid, prompt length, served tokens) of the requests the
    window finished. The longest first, then, for every kind of dispatch a
    request took part in during the window, one request that took part in
    it (one still in flight at the close, with the tokens it was served by
    then, where no finished one did), then others in an order drawn from
    the seed, until ``served_target`` served tokens or ``tokens_max``
    tokens in all are reached."""
    if not cands:
        return []
    order = [cands[i] for i in np.random.default_rng([seed, 5]).permutation(len(cands))]
    chosen = [max(cands, key=lambda c: (c[2], -c[0]))]
    wanted = sorted(set().union(*kinds.values())) if kinds else []
    spare = [inflight[i] for i in np.random.default_rng([seed, 6]).permutation(len(inflight))]
    for k in wanted:
        if not any(k in kinds.get(c[0], ()) for c in chosen):
            pick = next((c for c in order + spare
                         if k in kinds.get(c[0], ()) and c not in chosen), None)
            if pick is not None:
                chosen.append(pick)
    for c in order:
        if sum(x[2] for x in chosen) >= served_target:
            break
        if c not in chosen and sum(x[1] + x[2] for x in chosen) + c[1] + c[2] <= tokens_max:
            chosen.append(c)
    return chosen


def gaps(ref, config: dict, weights: dict, streams: list, device, *,
         control: bool = False, rows: int = 1024) -> dict:
    """``streams``: (prompt ids, served ids). Per served token, the
    reference's best logit at its position less the token's own; with
    ``control``, also less the logit of the token the float8 reference puts
    first there."""
    seqs = [torch.as_tensor(np.concatenate([p, s[:-1]]), dtype=torch.long, device=device)
            for p, s in streams]
    out = {"program": [], "control": []}
    with torch.no_grad():
        hid = ref.final_hidden(config, weights, seqs)
        hid_c = ref.final_hidden(config, weights, seqs, quant="fp8") if control else None
        head = ref.head(weights)
        head_c = ref.head(weights, quant="fp8") if control else None
        for i, (p, s) in enumerate(streams):
            P = len(p)
            served = torch.as_tensor(np.asarray(s), dtype=torch.long, device=device)
            for a in range(0, len(s), rows):
                h = hid[i][P - 1 + a: P - 1 + min(a + rows, len(s))]
                lg = head(h)
                best = lg.max(dim=-1).values
                got = lg.gather(1, served[a: a + h.shape[0], None])[:, 0]
                out["program"].append((best - got).cpu())
                if control:
                    pick = head_c(hid_c[i][P - 1 + a: P - 1 + a + h.shape[0]]).argmax(dim=-1)
                    out["control"].append((best - lg.gather(1, pick[:, None])[:, 0]).cpu())
    res = {}
    for k, v in out.items():
        if v:
            g = torch.cat(v)
            res[k] = {"widest": float(g.max()), "mean": float(g.mean()),
                      "share_not_best": float((g > 0).float().mean()), "tokens": int(g.numel())}
    return res
