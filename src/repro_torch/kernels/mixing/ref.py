"""Plain PyTorch version of the gossip-mix kernel."""
import torch


def gossip_mix_ref(buffer: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """``out[b, :] = sum_i w[i] * buffer[b, i, :]`` over a ``(batch, n, p)``
    buffer, summed in f32 in order i = 0..n-1 (the kernel's order, so the
    kernel matches it bit for bit), written in the buffer's dtype."""
    w = weights.float()
    acc = torch.zeros((buffer.shape[0], buffer.shape[2]), dtype=torch.float32,
                      device=buffer.device)
    for i in range(buffer.shape[1]):
        acc = acc + w[i] * buffer[:, i].float()
    return acc.to(buffer.dtype)
