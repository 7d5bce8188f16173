"""Model FLOPs utilisation: segments a second times the model's training
FLOPs a segment, over the configuration's peak, in percent."""


def read(r):
    return 100.0 * r.segments_per_s * r.flops_per_segment / r.peak_flops
