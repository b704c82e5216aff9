"""The one-by-one comparison of answers with the reference's: each answer
(the log-probability of the action the rollout took, and the value it
stored for that position) is within its tolerance or off, and the numbers
compared are the shares of answers off, with the actions that were not
legal. A tolerance is an answer's distance from the float32 reference that
no sound bf16 answer reached over the readings that set the limits
(PERF.md §2); a share counts the answers beyond it.
"""

from __future__ import annotations

import torch

TAU_LOGP = 0.01    # nats
TAU_VALUE = 0.003  # value in [-1, 1]
# the tolerances the calibration also reads, to show how the shares fall off
LOGP_TAUS = (0.005, 0.01, 0.015, 0.02, 0.03)
VALUE_TAUS = (0.002, 0.003, 0.005, 0.01)


def first_of_each(rows: torch.Tensor) -> torch.Tensor:
    """The index of the first occurrence of each distinct row (by its bits)."""
    n = rows.shape[0]
    key = rows.reshape(n, -1).contiguous().view(torch.int32)
    _, inverse = torch.unique(key, dim=0, return_inverse=True)
    first = torch.full((int(inverse.max()) + 1,), n, dtype=torch.long, device=rows.device)
    return first.scatter_reduce_(0, inverse, torch.arange(n, device=rows.device), "amin")


def answer_gaps(logp, value, ref_logp, ref_value, masks, actions, obs=None) -> dict:
    """illegal actions, shares of log-probs and values off, and (not
    compared, "_") the widest gaps and the shares at other tolerances; with
    the answers' observations `obs`, the shares over distinct answers too."""
    logp, value = logp.reshape(-1).float(), value.reshape(-1).float()
    dl = (logp - ref_logp.reshape(-1)).abs()
    dv = (value - ref_value.reshape(-1)).abs()
    legal = masks.reshape(dl.shape[0], -1).gather(1, actions.reshape(-1, 1).long())[:, 0]
    out = {"illegal_actions": int((~legal).sum()),
           "logp_off_share": float((dl > TAU_LOGP).float().mean()),
           "value_off_share": float((dv > TAU_VALUE).float().mean()),
           "_logp_gap": float(dl.max()), "_value_gap": float(dv.max()),
           "_logp_rms": float(dl.pow(2).mean().sqrt()),
           "_value_rms": float(dv.pow(2).mean().sqrt()), "_answers": int(dl.numel())}
    out["_logp_shares"] = [float((dl > t).float().mean()) for t in LOGP_TAUS]
    out["_value_shares"] = [float((dv > t).float().mean()) for t in VALUE_TAUS]
    if obs is not None:
        o = obs.reshape(dl.shape[0], -1).float()
        pos = first_of_each(o)
        ans = first_of_each(torch.cat([o, actions.reshape(-1, 1).float()], dim=1))
        out["_distinct_positions"] = float(pos.numel() / dl.numel())
        out["_logp_off_share_distinct"] = float((dl[ans] > TAU_LOGP).float().mean())
        out["_value_off_share_distinct"] = float((dv[pos] > TAU_VALUE).float().mean())
    return out
