# coding: utf-8
"""Default hyperparameters: the same keys and defaults as the JAX package's
deepvoice3_pytorch_tpu/hparams.py, so its JSON presets load unchanged
(tests/test_torch_host.py pins the equality)."""

from .config import HParams


def default_hparams():
    return HParams(
        name="deepvoice3",

        # Text:
        frontend='en',
        # Replace words with pronunciation with this probability.
        replace_pronunciation_prob=0.5,

        # Convenient model builder: [deepvoice3, deepvoice3_multispeaker, nyanko]
        builder="deepvoice3",

        n_speakers=1,
        speaker_embed_dim=16,

        # Audio:
        num_mels=80,
        fmin=125,
        fmax=7600,
        fft_size=1024,
        hop_size=256,
        sample_rate=22050,
        preemphasis=0.97,
        min_level_db=-100,
        ref_level_db=20,
        rescaling=False,
        rescaling_max=0.999,
        allow_clipping_in_normalization=True,

        # Model:
        downsample_step=4,   # must be 4 when builder="nyanko"
        outputs_per_step=1,  # must be 1 when builder="nyanko"
        embedding_weight_std=0.1,
        speaker_embedding_weight_std=0.01,
        padding_idx=0,
        max_positions=512,
        dropout=1 - 0.95,
        kernel_size=3,
        text_embed_dim=128,
        encoder_channels=256,
        decoder_channels=256,
        converter_channels=256,
        query_position_rate=1.0,
        key_position_rate=1.385,  # 2.37 for jsut
        key_projection=False,
        value_projection=False,
        use_memory_mask=True,
        trainable_positional_encodings=False,
        freeze_embedding=False,
        use_decoder_state_for_postnet_input=True,

        # Data loader
        pin_memory=True,
        num_workers=2,

        # Loss
        masked_loss_weight=0.5,
        priority_freq=3000,
        priority_freq_weight=0.0,
        binary_divergence_weight=0.1,
        use_guided_attention=True,
        guided_attention_sigma=0.2,

        # Training:
        batch_size=16,
        adam_beta1=0.5,
        adam_beta2=0.9,
        adam_eps=1e-6,
        amsgrad=False,
        initial_learning_rate=5e-4,
        lr_schedule="noam_learning_rate_decay",
        lr_schedule_kwargs={},
        nepochs=2000,
        weight_decay=0.0,
        clip_thresh=0.1,

        # Save
        checkpoint_interval=10000,
        eval_interval=10000,
        save_optimizer_state=True,

        # Eval:
        force_monotonic_attention=True,
        window_ahead=3,
        window_backward=1,
        power=1.4,

        # json_meta mode only
        ignore_recognition_level=2,
        min_text=20,
        process_only_htk_aligned=False,

        # --- additions of the JAX package (not in the reference) ---
        griffin_lim_iters=16,       # phase retrieval iterations
        griffin_lim_phase_init="spsi",  # "spsi" per-bin interpolated-
                                    # frequency phase start, or "zero"
        griffin_lim_momentum=0.9,   # fast Griffin-Lim acceleration
        max_decoder_steps=500,      # static decode length bound
        length_bucket_step=32,      # pad text lengths to multiples
        frame_bucket_step=64,       # pad decoder lengths to multiples
        mesh_data_axis=-1,          # -1: every rank not on the model
                                    # axis is on the data axis; neither
                                    # package reads it: parallel/mesh.py's
                                    # make_mesh takes the ranks and
                                    # --mesh-model, as JAX's train.py
        compute_dtype="float32",
        stft_mode="lws",            # "lws": causal framing, PR-normalized
                                    # sqrt-Hann; "center": librosa-style
                                    # reflect-padded, periodic sqrt-Hann
        phase_retrieval="gl",       # "gl" momentum Griffin-Lim; "lws"
                                    # local weighted sums (hop | fft)
        griffin_lim_matmul_dtype="",  # JAX XLA-loop knobs; the port runs
        griffin_lim_carry_dtype="bfloat16",  # one bf16-carry schedule
    )


hparams = default_hparams()


def hparams_debug_string(hp=None):
    values = (hp or hparams).values()
    lines = ['  %s: %s' % (name, values[name]) for name in sorted(values)]
    return 'Hyperparameters:\n' + '\n'.join(lines)
