"""The MLP FHVAE's model FLOPs a training segment, for ``mfu``: the
products of its three ReLU MLPs, its Gaussian heads (the decoder's over the
flattened segment) and the discriminative term over the table's
``num_seqs`` rows; a multiply-add is two operations and training is three
times the forward. Elementwise work is left out."""

from roofline import PEAKS  # noqa: F401  (the harness reads the peak here)


def flops_per_segment(w: dict, num_seqs: int, train: bool = True) -> float:
    d, z1, z2 = w["seg_len"] * w["feat_dim"], w["z1_dim"], w["z2_dim"]

    def mlp(d_in, hus):
        macs = 0
        for h in hus:
            macs += d_in * h
            d_in = h
        return macs

    macs = (mlp(d, w["z2_hus"]) + 2 * w["z2_hus"][-1] * z2
            + mlp(d + z2, w["z1_hus"]) + 2 * w["z1_hus"][-1] * z1
            + mlp(z1 + z2, w["x_hus"]) + 2 * w["x_hus"][-1] * d
            + z2 * num_seqs)
    return 2.0 * macs * (3.0 if train else 1.0)
