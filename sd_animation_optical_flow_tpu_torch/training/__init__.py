"""Port of sd_animation_optical_flow_tpu/training: the diffusion
fine-tuning step (on one card or sharded dp x tp), the flow-training path
(synthetic scenes, the RAFT sequence loss and train step, the
uncertainty-head step, pretraining and evaluation), and the host-side
training data (``flow_data.py``: augmentors and the dataset catalog;
``degradation.py``: the BSRGAN degradations). The flow-training names
resolve lazily."""

_LAZY = {
    "FlowScene": "synthetic_flow",
    "render_scene": "synthetic_flow",
    "synthetic_batch": "synthetic_flow",
    "sequence_loss": "flow_train",
    "make_flow_optimizer": "flow_train",
    "FlowTrainState": "flow_train",
    "init_flow_train_state": "flow_train",
    "flow_train_step": "flow_train",
    "uncertainty_nll_loss": "flow_train",
    "uncertainty_train_step": "flow_train",
    "train_raft_synthetic": "uncertainty_pretrain",
    "train_head_synthetic": "uncertainty_pretrain",
    "eval_epe": "uncertainty_pretrain",
    "evaluate_masks": "uncertainty_pretrain",
    "evaluate": "flow_eval",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return getattr(importlib.import_module(f"{__name__}.{_LAZY[name]}"),
                       name)
    raise AttributeError(name)
