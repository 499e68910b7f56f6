from deeplio_tpu_torch.losses.pose import init_loss_params, pose_loss
