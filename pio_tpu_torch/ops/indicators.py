"""Technical indicators over (time, tickers) log-price matrices.

Counterpart of ``pio_tpu.ops.indicators``, in torch on the input's device:
every indicator is (T, N) in, (T, N) out, over all tickers at once
(reference examples/experimental/scala-stock/src/main/scala/
Indicators.scala computes them per symbol). Rolling means are cumsum
differences; the EMA is a recurrence down T, run a row at a time, so each
row is the same two f32 products and one sum as the reference's
``lax.scan`` step.

All functions take log prices; leading positions that lack a full window
are emitted as 0 (the reference fills NA with 0,
Indicators.scala getRet `.fillNA(_ => 0.0)`).
"""

from __future__ import annotations

import torch


def log_returns(log_price: torch.Tensor, d: int = 1) -> torch.Tensor:
    """d-day log return: x_t - x_{t-d}; first d rows are 0 (reference
    RegressionStrategy.getRet / ShiftsIndicator)."""
    out = log_price - torch.roll(log_price, d, dims=0)
    out[:d] = 0.0
    return out


def rolling_mean(x: torch.Tensor, window: int) -> torch.Tensor:
    """Trailing mean over `window` rows via cumsum difference; rows with an
    incomplete window are 0."""
    c = torch.cumsum(x, dim=0)
    c = torch.cat([torch.zeros_like(c[:1]), c], dim=0)
    # value at row t (t >= window-1) = mean of rows t-window+1 .. t
    out = (c[window:] - c[:-window]) / window
    pad = x.new_zeros((min(window - 1, x.shape[0]),) + tuple(x.shape[1:]))
    return torch.cat([pad, out], dim=0)[: x.shape[0]]


def rsi(log_price: torch.Tensor, period: int = 14) -> torch.Tensor:
    """Relative Strength Index on daily log returns (reference
    RSIIndicator: RS = rolling-mean(gains) / rolling-mean(losses),
    RSI = 100 - 100/(1+RS)); incomplete windows emit 0, flat windows 50."""
    ret = log_returns(log_price, 1)
    avg_g = rolling_mean(ret.clamp_min(0.0), period)
    avg_l = rolling_mean((-ret).clamp_min(0.0), period)
    rs = avg_g / avg_l.clamp_min(1e-12)
    out = 100.0 - 100.0 / (1.0 + rs)
    # flat window (no gains, no losses): RSI conventionally 50
    flat = (avg_g <= 1e-12) & (avg_l <= 1e-12)
    out = torch.where(flat, torch.full_like(out, 50.0), out)
    # rows [:period] contain the artificial zero return at row 0 inside the
    # window; row `period` is the first RSI over `period` real returns
    out[:period] = 0.0
    return out


def ema(x: torch.Tensor, period: int) -> torch.Tensor:
    """Exponential moving average (alpha = 2/(period+1)) down the time
    axis, seeded with the first row."""
    alpha = 2.0 / (period + 1.0)
    out = torch.empty_like(x)
    carry = x[0]
    for t in range(x.shape[0]):
        carry = alpha * x[t] + (1 - alpha) * carry
        out[t] = carry
    return out


def indicator_matrix(log_price: torch.Tensor, spec: tuple) -> torch.Tensor:
    """(T, N) log prices -> (T, N, F) feature tensor for the strategy
    regression. spec entries: ("return", d) | ("rsi", period) |
    ("ema_ratio", period) — the reference's indicator set
    (ShiftsIndicator / RSIIndicator) plus an EMA-distance feature."""
    feats = []
    for kind, arg in spec:
        if kind == "return":
            feats.append(log_returns(log_price, int(arg)))
        elif kind == "rsi":
            feats.append(rsi(log_price, int(arg)) / 100.0)  # scale to ~[0,1]
        elif kind == "ema_ratio":
            feats.append(log_price - ema(log_price, int(arg)))
        else:
            raise ValueError(f"unknown indicator {kind!r}")
    return torch.stack(feats, dim=-1)
