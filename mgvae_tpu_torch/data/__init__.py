"""Host-side data layer of the port: numpy, with the native host library
(``mgvae_tpu_torch/native``) building the collate's tables where it loads."""
