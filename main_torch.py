"""The PyTorch port's CLI beside the JAX one (main.py): the reference's
flags, run on an NVIDIA GPU.

    python main_torch.py --input_path pc_examples/mouse.npy --input_type pc_normal
"""
from meshanything_tpu_torch.cli import main

if __name__ == "__main__":
    main()
