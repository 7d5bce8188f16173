"""The port's checkpoint layer: JAX leaf order, JAX .npz load, own save."""

import jax
import numpy as np
import pytest
import torch

from pytorch_scalablefhvae_tpu.models.fhvae import FHVAE as JaxFHVAE
from pytorch_scalablefhvae_tpu.train import checkpoint as jax_ckpt
from pytorch_scalablefhvae_tpu.train.step import (
    create_train_state,
    make_optimizer,
)
from pytorch_scalablefhvae_tpu_torch.models.fhvae import FHVAE
from pytorch_scalablefhvae_tpu_torch.train import checkpoint as ckpt

T, F, NSEQ = 5, 8, 5
DIMS = dict(z1_hus=(16, 16), z2_hus=(16, 16), x_hus=(16, 16), z1_dim=4,
            z2_dim=4, feat_dim=F)


def jax_state(num_seqs=NSEQ):
    model = JaxFHVAE(input_size=T * F, num_seqs=num_seqs, **DIMS)
    return model, create_train_state(model, make_optimizer(1e-3, 0.95, 0.999),
                                     seed=0)


def port_model(num_seqs=NSEQ, seed=1):
    return FHVAE(T * F, num_seqs=num_seqs,
                 generator=torch.Generator().manual_seed(seed), **DIMS)


def _path_name(path) -> str:
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def test_leaf_order_matches_jax_tree_leaves():
    _, state = jax_state()
    names = ckpt.jax_leaf_names(port_model().state_dict().keys())
    with_path = jax.tree_util.tree_flatten_with_path(state.params)[0]
    assert names == [_path_name(p) for p, _ in with_path]
    # TrainState's params are its first leaves
    leaves = jax.tree_util.tree_leaves(state)
    params = ckpt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         state.params))
    for i, name in enumerate(names):
        np.testing.assert_array_equal(np.asarray(leaves[i]),
                                      params[name].numpy())


def test_jax_npz_loads_into_port(tmp_path):
    jm, state = jax_state()
    path = jax_ckpt.save_checkpoint(
        tmp_path, state, model_type="fhvae", model_params=jm.model_params(),
        run_info="t", epoch=0, best_epoch=0, best_val_lb=-1.0, values={},
        extra_meta={"num_seqs": NSEQ, "feat_dim": F})
    tm = port_model()
    meta = ckpt.load_params(path, tm)
    assert meta["num_seqs"] == NSEQ
    want = ckpt.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                       state.params))
    for k, v in tm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), err_msg=k)
    assert ckpt.find_best_checkpoint(tmp_path).name.startswith("best_model_")
    assert ckpt.find_epoch_checkpoint(tmp_path, -1) == path
    # the inverse pair carries the weights back to the JAX layout
    back = ckpt.params_to_jax(tm.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, state.params))


def test_padded_mu2_table_adapts_rows(tmp_path):
    """A table saved padded to a mesh's model axis (more rows) loads into
    the unpadded model: the padding rows are sliced off."""
    jm, state = jax_state(num_seqs=NSEQ + 3)
    path = jax_ckpt.save_checkpoint(
        tmp_path, state, model_type="fhvae", model_params=jm.model_params(),
        run_info="t", epoch=0, best_epoch=0, best_val_lb=-1.0, values={})
    tm = port_model()
    ckpt.load_params(path, tm)
    np.testing.assert_array_equal(
        tm.mu2_table.detach().numpy(),
        np.asarray(state.params["mu2_table"])[:NSEQ])


def test_port_save_load_round_trip(tmp_path):
    src = port_model(seed=2)
    path = ckpt.save_checkpoint(
        tmp_path, src, model_type="fhvae", model_params=src.model_params(),
        run_info="rt", epoch=3, best_epoch=3, best_val_lb=-2.0, values={},
        extra_meta={"num_seqs": NSEQ})
    with np.load(path) as z:
        assert set(z.files) == set(src.state_dict())  # named, not positional
    dst = port_model(seed=3)
    meta = ckpt.load_params(path, dst)
    assert meta["format"] == ckpt.PORT_FORMAT and meta["epoch"] == 3
    for k, v in src.state_dict().items():
        torch.testing.assert_close(dst.state_dict()[k], v, rtol=0, atol=0)
    assert ckpt.find_best_checkpoint(tmp_path).name == \
        "best_model_fhvae_rt_e3.npz"


def test_orbax_and_shape_mismatch_raise(tmp_path):
    """An orbax directory that the JAX package wrote is refused, naming
    ROADMAP.md (reading one needs the orbax package; the port's own
    ``--ckpt-backend orbax`` directories load: ``tests/test_torch_orbax.py``);
    a shape mismatch raises naming the parameter."""
    from pytorch_scalablefhvae_tpu.train import orbax_backend as jax_orbax

    jm, state = jax_state()
    written = jax_orbax.save_checkpoint_orbax(
        tmp_path / "jax", state, model_type="fhvae", run_info="t", epoch=0,
        meta={"best_epoch": 0, "best_val_lb": -1.0, "values": {},
              "model_params": list(jm.model_params())})
    jax_orbax.wait_for_saves()
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ckpt.load_params(written, port_model())
    src = port_model()
    path = ckpt.save_checkpoint(
        tmp_path, src, model_type="fhvae", model_params=src.model_params(),
        run_info="w", epoch=0, best_epoch=0, best_val_lb=0.0, values={})
    wide = FHVAE(T * F, num_seqs=NSEQ, **{**DIMS, "x_hus": (32, 32)})
    with pytest.raises(ValueError, match="dec_"):
        ckpt.load_params(path, wide)
