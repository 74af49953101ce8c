"""FCDNN-16 (paper §VI-A): a fully connected autoencoder with ReLU and 16
hidden layers, encoder dims [64,128,256,512,256,128,64,32] and the
symmetric decoder, on 784-dim (MNIST-like) inputs.  The model
Proposition 3.1 is validated on.  A copy of the reference's
``configs/fcdnn16.py``."""

ENCODER_DIMS = (64, 128, 256, 512, 256, 128, 64, 32)
DECODER_DIMS = tuple(reversed(ENCODER_DIMS))
INPUT_DIM = 784  # MNIST-like

# not a ModelConfig: the paper's toy FC model, built and run by
# repro_torch/models/fcdnn.py
FULL = None


def smoke():
    return None
