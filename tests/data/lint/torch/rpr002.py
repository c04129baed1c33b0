"""RPR002 fixture: random draws from the hidden global generator."""
import torch


def sample(n, device):
    a = torch.randn(n, device=device)      # RPR002: no generator
    idx = torch.randperm(n)                # RPR002: no generator
    b = torch.empty(n).uniform_()          # RPR002: in-place sampler
    return a, idx, b


def sample_clean(n, seed, device):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(n, generator=g).to(device)
    idx = torch.randperm(n, generator=g)
    b = torch.empty(n).uniform_(generator=g)
    return a, idx, b
