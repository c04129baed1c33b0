"""RPR005 fixture: bf16 reductions without an f32 accumulator."""
import torch


def accumulate(w, x):
    wb = w.to(torch.bfloat16)
    total = torch.sum(wb)                  # RPR005: accumulates in bf16
    m = wb.mean()                          # RPR005: method form
    prod = torch.matmul(wb, x)             # RPR005: product in bf16
    return total, m, prod


def accumulate_clean(w, x):
    wb = w.to(torch.bfloat16)
    total = torch.sum(wb, dtype=torch.float32)
    wf = wb.float()
    return total, torch.matmul(wf, x)
