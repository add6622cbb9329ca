"""The PyTorch port's server beside the JAX one (app.py): the gradio UI
where gradio imports, else the HTTP server, on an NVIDIA GPU.

    python app_torch.py [--pretrained_weights MeshAnything_350m.pth] [--fast]
"""
from meshanything_tpu_torch.serving import main

if __name__ == "__main__":
    main()
