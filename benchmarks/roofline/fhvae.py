"""The recurrent FHVAE's model FLOPs a training segment, for ``mfu``:
the matrix products of the three LSTM stacks (every frame's input
projection and recurrent products, as the model defines them), the Gaussian
heads and the discriminative term over the table's ``num_seqs`` rows; a
multiply-add is two operations and training is three times the forward.
Elementwise work is left out."""

from roofline import PEAKS  # noqa: F401  (the harness reads the peak here)


def flops_per_segment(w: dict, num_seqs: int, train: bool = True) -> float:
    t, f, z1, z2 = w["seg_len"], w["feat_dim"], w["z1_dim"], w["z2_dim"]

    def lstm(d_in, hus):
        macs, d = 0, d_in
        for h in hus:
            macs += t * (d * 4 * h + h * 4 * h)
            d = h
        return macs

    macs = (lstm(f, w["z2_hus"]) + 2 * w["z2_hus"][-1] * z2
            + lstm(f + z2, w["z1_hus"]) + 2 * w["z1_hus"][-1] * z1
            + lstm(z1 + z2, w["x_hus"]) + t * 2 * w["x_hus"][-1] * f
            + z2 * num_seqs)
    return 2.0 * macs * (3.0 if train else 1.0)
