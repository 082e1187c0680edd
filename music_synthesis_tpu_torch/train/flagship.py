"""The flagships' training recipes, at full width.

Stage 2: ``FLAGSHIP_SECTIONS`` holds the msd/mrd/stft_loss/train sections
of the flagship run (``runs/stage2_istft_long/config.json``) as a literal,
so that a checkout without ``runs/`` can build it; a CPU test holds it
equal to the file. The front-end, MelScaler and vocoder come from the zoo
card of the vocoder that run trained (``zoo/vocoder_istft``).

Stage 1: ``STAGE1_TRAIN`` is the train section of the composer's run
(``runs/stage1_flux_40k/config.json``: batch 16, instance noise 0.2
decaying over 10k steps, R1 1, flux 10, EMA 0.999); the specgan section,
front-end and MelScaler come from its zoo card (``zoo/specgan_flux``).
"""

from __future__ import annotations

import dataclasses

from music_synthesis_tpu_torch.config import (
    PipelineConfig,
    TrainConfig,
    config_from_dict,
    section_from_dict,
)

__all__ = ["FLAGSHIP_SECTIONS", "STAGE1_TRAIN", "flagship_config",
           "stage1_flagship_config", "zoo_train_state"]

FLAGSHIP_SECTIONS = {
    "msd": {"n_scales": 3, "downsample_factor": 2,
            "channels": [16, 64, 256, 1024, 1024], "kernel": 41,
            "strides": [4, 4, 4, 4], "groups": [4, 16, 64, 256],
            "input_kernel": 15, "post_kernel": 5, "output_kernel": 3,
            "leaky_slope": 0.2, "use_weight_norm": True,
            "compute_dtype": "bfloat16", "dense_groups_max_g": 16},
    "mrd": {"resolutions": [[512, 128, 512], [1024, 256, 1024],
                            [2048, 512, 2048]],
            "channels": 32, "leaky_slope": 0.2, "use_weight_norm": True,
            "compute_dtype": "bfloat16", "f_fold": 4, "input_mode": "logmag",
            "complex_compression": 0.3},
    "stft_loss": {"resolutions": [[512, 128, 512], [1024, 256, 1024],
                                  [2048, 512, 2048]], "eps": 1e-07},
    "train": {"batch_size": 16, "segment_length": 8192, "augment": False,
              "g_lr": 0.0001, "d_lr": 0.0001, "adam_b1": 0.5, "adam_b2": 0.9,
              "lr_decay_rate": 1.0, "lr_decay_every": 1000,
              "grad_clip_norm": 0.0, "remat_generator": False,
              "ema_decay": 0.999, "reuse_real_features": True,
              "concat_disc_batch": True, "gan_loss": "hinge",
              "d_input_noise": 0.1, "d_noise_decay_steps": 20000,
              "r1_gamma": 1.0, "lambda_feature_matching": 10.0,
              "lambda_stft": 2.5, "lambda_energy": 0.0, "lambda_flux": 0.0,
              "lambda_phase": 0.0, "phase_n_fft": 1024, "phase_hop": 256,
              "g_warmup_steps": 5000, "seed": 0, "checkpoint_every": 1000,
              "log_every": 50, "use_pallas_frontend": True,
              "mesh_shape": [1], "mesh_axes": ["data"]},
}


STAGE1_TRAIN = {
    "batch_size": 16, "segment_length": 8192, "augment": False,
    "g_lr": 0.0001, "d_lr": 0.0001, "adam_b1": 0.5, "adam_b2": 0.9,
    "lr_decay_rate": 1.0, "lr_decay_every": 1000, "grad_clip_norm": 0.0,
    "remat_generator": False, "ema_decay": 0.999,
    "reuse_real_features": False, "concat_disc_batch": False,
    "gan_loss": "hinge", "d_input_noise": 0.2, "d_noise_decay_steps": 10000,
    "r1_gamma": 1.0, "lambda_feature_matching": 10.0, "lambda_stft": 2.5,
    "lambda_energy": 0.0, "lambda_flux": 10.0, "g_warmup_steps": 0,
    "seed": 0, "checkpoint_every": 1000, "log_every": 50,
    "use_pallas_frontend": False, "mesh_shape": [1], "mesh_axes": ["data"],
}


def flagship_config(entry=None) -> PipelineConfig:
    """The flagship's PipelineConfig: ``FLAGSHIP_SECTIONS`` plus the
    front-end, MelScaler and vocoder of ``zoo/vocoder_istft``'s card
    (``entry``, a ``zoo.load_pretrained`` result, if given)."""
    from music_synthesis_tpu_torch import zoo

    entry = entry or zoo.load_pretrained("vocoder_istft")
    return dataclasses.replace(config_from_dict(FLAGSHIP_SECTIONS),
                               frontend=entry.frontend,
                               mel_scaler=entry.mel_scaler,
                               vocoder=entry.config)


def stage1_flagship_config(entry=None) -> PipelineConfig:
    """The stage-1 flagship's PipelineConfig: ``STAGE1_TRAIN`` plus the
    specgan section, front-end and MelScaler of ``zoo/specgan_flux``'s card
    (``entry``, a ``zoo.load_pretrained`` result, if given)."""
    from music_synthesis_tpu_torch import zoo

    entry = entry or zoo.load_pretrained("specgan_flux")
    return PipelineConfig(train=section_from_dict(TrainConfig, STAGE1_TRAIN),
                          specgan=entry.config, frontend=entry.frontend,
                          mel_scaler=entry.mel_scaler)


def zoo_train_state(cfg: PipelineConfig, entry, device=None, seed: int = 0):
    """A fresh training state with G (and its EMA) from the zoo entry and D
    from a seeded init, on ``cuda`` unless ``device`` says otherwise; a
    stage-1 state for a composer (``specgan``) entry, else stage 2."""
    from music_synthesis_tpu_torch.train import stage1, stage2

    stage = stage1 if entry.kind == "specgan" else stage2
    state = stage.make_train_state(cfg, seed=seed, device=device)
    dev = next(iter(state.g_params.values())).device
    g = {k: v.to(dev) for k, v in entry.state_dict.items()}
    if g.keys() != state.g_params.keys():
        raise ValueError("the zoo entry's parameters are not those of "
                         "cfg's generator")
    return dataclasses.replace(state, g_params=g,
                               g_ema={k: v.clone() for k, v in g.items()})
