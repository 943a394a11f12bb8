"""CLIP dual encoder with HF parameter names, and the weight bridge."""
