"""Training losses, NCHW (port of human_pose_tpu/train/losses.py).

* ``classification_loss``: the mean softmax cross entropy of integer
  labels, the log-softmax in float32;
* ``heatmaps_loss``: crowd-masked MSE over the keypoint heatmaps of one
  stage, mean over every element.
* ``ae_grouping_loss``: the associative-embedding push and pull. Tags are
  read at each visible joint's integer coordinates (clipped into the map) in
  the 1/4-resolution tag map; pull is the variance of a person's tags around
  their mean, push ``exp(-(ref_i - ref_j)^2)`` over pairs of persons, halved
  and divided by ``(num_obj - 1) * num_obj`` (at least 1). Persons without a
  visible joint are skipped, and the batch mean counts empty samples.
* ``ae_keypoints_loss``: the heatmap losses of every stage plus
  ``TAG_LOSS_WEIGHT * (push + pull)``.
* ``joints_mse_loss``: the top-down nets' target-weighted joints MSE
  (pose_hrnet's ``JointsMSELoss(use_target_weight=True)``), summed over
  the stages of a list.

Joints are ``[N, P, K, 3]`` int32 ``(x, y, vis)`` at 1/4-resolution
coordinates, padded with vis 0. Every loss is float32.
"""

from __future__ import annotations

import torch

TAG_LOSS_WEIGHT = 1e-3


def classification_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean NLL of ``labels`` ``[N]`` under ``log_softmax(logits [N, C])``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def heatmaps_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked MSE. ``pred``, ``target`` ``[N, K, h, w]``, ``mask`` ``[N, h, w]``."""
    err = (pred.float() - target.float()) ** 2
    return (err * mask[:, None]).mean()


def _sample_ae(pred_tags: torch.Tensor, joints: torch.Tensor):
    """Push and pull of every sample: ``pred_tags`` ``[N, K, h, w]`` float32,
    ``joints`` ``[N, P, K, 3]``. Returns ``(push [N], pull [N])``."""
    n, k, h, w = pred_tags.shape
    xc = joints[..., 0].long().clamp(0, w - 1)
    yc = joints[..., 1].long().clamp(0, h - 1)
    vis = joints[..., 2] > 0  # [N, P, K]
    ni = torch.arange(n, device=pred_tags.device)[:, None, None]
    ki = torch.arange(k, device=pred_tags.device)[None, None, :]
    zero = pred_tags.new_zeros(())
    tags = torch.where(vis, pred_tags[ni, ki, yc, xc], zero)  # [N, P, K]

    n_vis = vis.sum(2).float()  # [N, P]
    person_valid = n_vis > 0
    safe_n = n_vis.clamp(min=1.0)
    ref_tag = tags.sum(2) / safe_n  # [N, P] mean tag of each person

    dev = torch.where(vis, (tags - ref_tag[..., None]) ** 2, zero)
    pull_per = dev.sum(2) / safe_n
    num_obj = person_valid.sum(1).float()  # [N]
    pull = torch.where(num_obj > 0,
                       torch.where(person_valid, pull_per, zero).sum(1) / num_obj.clamp(min=1.0),
                       zero)

    dd = (ref_tag[:, :, None] - ref_tag[:, None, :]) ** 2
    pair_valid = person_valid[:, :, None] & person_valid[:, None, :]
    push_sum = torch.where(pair_valid, torch.exp(-dd), zero).sum((1, 2)) - num_obj
    denom = ((num_obj - 1.0) * num_obj).clamp(min=1.0)
    push = torch.where(num_obj > 1, push_sum / denom * 0.5, zero)
    return push, pull


def ae_grouping_loss(pred_tags: torch.Tensor, joints: torch.Tensor):
    """Batch push and pull: ``pred_tags`` ``[N, K, h, w]`` (1/4-resolution
    tag maps), ``joints`` ``[N, P, K, 3]``. The sums over the batch are
    divided by N, empty samples included."""
    push, pull = _sample_ae(pred_tags.float(), joints)
    n = pred_tags.shape[0]
    return push.sum() / n, pull.sum() / n


def ae_keypoints_loss(stages_pred_heatmaps: list, pred_tags: torch.Tensor,
                      stages_target_heatmaps: list, masks: list, joints_quarter: torch.Tensor):
    """The pose loss: ``sum(heatmap loss of each stage) + push + pull`` with
    push and pull weighted by ``TAG_LOSS_WEIGHT``. Returns ``(total,
    metrics)``; the metrics are ``hm_{i}``, ``push``, ``pull`` and ``loss``."""
    hm_losses = [heatmaps_loss(p, t, m)
                 for p, t, m in zip(stages_pred_heatmaps, stages_target_heatmaps, masks)]
    push, pull = ae_grouping_loss(pred_tags, joints_quarter)
    push = push * TAG_LOSS_WEIGHT
    pull = pull * TAG_LOSS_WEIGHT
    total = sum(hm_losses) + push + pull
    metrics = {f"hm_{i}": loss for i, loss in enumerate(hm_losses)}
    metrics.update({"push": push, "pull": pull, "loss": total})
    return total, metrics


def joints_mse_loss(stages_pred_heatmaps: list, target: torch.Tensor,
                    target_weight: torch.Tensor):
    """The top-down loss: for each stage ``[N, K, h, w]`` of the list,
    ``0.5 * mean((w * pred - w * target)^2)`` over N, K and the pixels, with
    ``target`` ``[N, K, h, w]`` (Gaussians on a zero background) and the
    joints' ``target_weight`` ``[N, K]`` (0 for a joint that is not
    labelled in the map: it contributes nothing); summed over the stages
    (intermediate supervision). Returns ``(total, metrics)``: ``hm_{i}`` a
    stage and ``loss``."""
    w = target_weight.float()[:, :, None, None]
    wt = target.float() * w
    hm_losses = [0.5 * ((p.float() * w - wt) ** 2).mean() for p in stages_pred_heatmaps]
    total = sum(hm_losses)
    metrics = {f"hm_{i}": loss for i, loss in enumerate(hm_losses)}
    metrics["loss"] = total
    return total, metrics
