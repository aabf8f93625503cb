from nerficg_torch.visual.colormaps import ColorMap, apply_color_map
