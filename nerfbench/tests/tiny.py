"""Cells cut to a size a CPU test can run: the same code, a few thousand
Gaussians, a few small views, a narrow MLP."""

from nerfbench.spec import Cell


def tiny_cell(name: str) -> Cell:
    cell = Cell(name)
    scene = cell.config['scene']
    if cell.config['method'] == 'GaussianSplatting':
        scene.update(count=16384, views=8, width=64, height=48)
        if 'width' in cell.traffic:
            cell.traffic.update(width=96, height=64)
            cell.traffic['path']['poses'] = 12
    else:
        scene.update(views=4, width=64, height=64)
        cell.config['port_config']['TRAINING']['RAYS_PER_BATCH'] = 64
        cell.config['port_config']['MODEL']['WIDTH'] = 64
    return cell
