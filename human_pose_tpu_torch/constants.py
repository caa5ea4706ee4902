"""Normalization constants (ImageNet mean/std of the reference's transforms,
src/base/transforms/base.py), kept in step with human_pose_tpu/constants.py."""

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# uint8 pixel closest to normalized zero, per channel: what the fp32 path's
# zero-padding feeds the network, expressed in the uint8 domain
PAD_PIXEL_U8 = tuple(int(round(m * 255.0)) for m in IMAGENET_MEAN)
