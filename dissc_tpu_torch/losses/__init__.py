"""GAN, rhythm and pitch losses (``dissc_tpu.losses``)."""
from dissc_tpu_torch.losses.gan import discriminator_loss, feature_loss, generator_loss
from dissc_tpu_torch.losses.len_loss import (
    len_exact_accuracy,
    len_mae_loss,
    len_mse_loss,
    len_one_off_accuracy,
    len_smooth_l1_loss,
    len_sum_loss,
)
from dissc_tpu_torch.losses.pitch_loss import pitch_loss, pitch_mae, pitch_mse
