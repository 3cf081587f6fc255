"""IODINE, iterative amortized inference (counterpart of
ocrl_tpu/models/iodine.py): ``num_slots`` Gaussian posteriors over slots of
``slot_size``, refined ``num_iterations`` times. Each iteration draws slots
(mean + exp(log sigma) * eps), decodes each slot to RGB and a mask logit
with the spatial-broadcast ``Decoder``, scores the image under the masks'
mixture (the ELBO), and feeds the refinement network with 17 maps per slot
(the image, the decoded RGB, mask, mask logit and mask posterior, the ELBO's
gradients with respect to the RGB and the mask, the likelihood, the
leave-one-out likelihood and the coordinates) and the posterior with the
ELBO's gradients with respect to it; an LSTM turns these into the
posterior's update.

The gradients are of B x ELBO: with respect to the posterior's mean and
log sigma through the draw and the decoder, with respect to the decoded
RGB and mask as they are. One ``torch.autograd.grad`` call gives all four;
they are detached, as JAX stops their gradients. The forward therefore
needs autograd even where its caller has none (a frozen OCR, a rollout's
policy call under ``inference_mode``): it opens it locally, and then builds
the inner graph from detached leaves and returns detached slots. Where the
caller records a graph (the OCR trained end to end), the outer graph runs
through every iteration as JAX's does, and the inner call retains it.

The representation is the slots drawn in the last iteration. That
iteration's refinement step feeds only the pretraining loss, so the
forward stops at the draw (and decodes once more only for the masks).
Noise is [num_iterations, B, K, L] (``eps_all`` of the JAX module), so a
policy slices its batch on axis 1 (``noise_batch_axis``); the loss and
``sample_arrays`` take it as ``noise["eps"]``.

The pretraining ``loss`` runs all ``num_iterations`` refinements: each
iteration's ELBO enters the loss, and the reported KL is that of the
posterior after the last refinement. Trained, the outer graph runs
through every iteration's refined posterior; the four inner gradients
carry none, as JAX stops theirs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..config import EnvConfig, IodineConfig
from ..utils.metrics import calculate_ari
from ..utils.viz import for_viz, visualize
from .common import dense, flax_conv, given_or_drawn, lecun_normal_


class MultiLayerConv(nn.ModuleList):
    """ELU conv stack, padding kernel // 2 (ocrl_tpu/models/iodine.py:26-43); NCHW."""

    def __init__(self, in_channels: int, features: int, n_layers: int, kernel_size: int,
                 stride: int = 1):
        super().__init__(flax_conv(in_channels if i == 0 else features, features,
                                   kernel_size, stride, kernel_size // 2)
                         for i in range(n_layers))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self:
            x = F.elu(conv(x))
        return x


class Decoder(nn.Module):
    """Spatial-broadcast decoder: [B, K, L] -> (RGB [B, K, H, W, 3], mask
    logits [B, K, H, W, 1]) (ocrl_tpu/models/iodine.py:46-93). The first
    conv's input, concat(broadcast(slot), coordinates), is linear in its two
    halves, so as in JAX it is evaluated as the slot half on a
    (2 pad + 1)^2 grid, tiled back to H x W, plus the coordinate half once,
    minus the bias counted twice. The tiling repeats the grid's middle row
    and column by expansion, not by an index: the inner gradient goes back
    through it twice a refinement step, and an index's backward is a
    scatter."""

    def __init__(self, slot_size: int, dim_hidden: int, n_layers: int, kernel_size: int,
                 img_size: int):
        super().__init__()
        self.img_size = img_size
        self.pad = pad = kernel_size // 2
        self.conv1 = flax_conv(slot_size + 2, dim_hidden, kernel_size, 1, pad)
        self.mlc = (MultiLayerConv(dim_hidden, dim_hidden, n_layers - 1, kernel_size)
                    if n_layers > 1 else None)
        self.conv_out = flax_conv(dim_hidden, 4, kernel_size, 1, pad)
        lin = torch.linspace(-1, 1, img_size)
        yy, xx = torch.meshgrid(lin, lin, indexing="ij")
        self.register_buffer("coords", torch.stack([xx, yy])[None], persistent=False)

    def _tile(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The (2 pad + 1) grid's axis ``dim`` stretched to the image: its
        first and last ``pad`` rows at the borders, its middle row repeated
        between them (an expand, whose backward is a sum)."""
        p, H = self.pad, self.img_size
        shape = list(x.shape)
        shape[dim] = H - 2 * p
        return torch.cat([x.narrow(dim, 0, p), x.narrow(dim, p, 1).expand(shape),
                          x.narrow(dim, p + 1, p)], dim)

    def forward(self, slots: torch.Tensor):
        B, K, L = slots.shape
        H = W = self.img_size
        g = 2 * self.pad + 1
        w, b = self.conv1.weight, self.conv1.bias
        small = F.conv2d(slots.reshape(B * K, L, 1, 1).expand(B * K, L, g, g), w[:, :L], b,
                         padding=self.pad)
        coordc = F.conv2d(self.coords, w[:, L:], b, padding=self.pad)
        x = F.elu(self._tile(self._tile(small, 2), 3) + coordc - b[:, None, None])
        if self.mlc is not None:
            x = self.mlc(x)
        x = self.conv_out(x).permute(0, 2, 3, 1)                 # NHWC
        return x[..., :3].reshape(B, K, H, W, 3), x[..., 3:].reshape(B, K, H, W, 1)


class LSTMCell(nn.Module):
    """flax's OptimizedLSTMCell with its gates i, f, g, o packed: ``ih``
    (no bias) holds the input kernels ii, if, ig, io, ``hh`` the hidden ones
    hi, hf, hg, ho with their biases. The carry is (c, h)."""

    def __init__(self, input_size: int, features: int):
        super().__init__()
        self.features = features
        self.ih = nn.Linear(input_size, 4 * features, bias=False)
        self.hh = nn.Linear(features, 4 * features)
        for k in range(4):
            block = slice(k * features, (k + 1) * features)
            lecun_normal_(self.ih.weight.data[block])
            nn.init.orthogonal_(self.hh.weight.data[block])
        nn.init.zeros_(self.hh.bias)

    def forward(self, carry, x: torch.Tensor):
        c, h = carry
        i, f, g, o = (self.ih(x) + self.hh(h)).chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return (c, h), h


class RefinementNetwork(nn.Module):
    """conv stack -> mean over the image -> ELU Dense -> with the posterior
    inputs, the LSTM -> the posterior's deltas
    (ocrl_tpu/models/iodine.py:96-134)."""

    def __init__(self, in_channels: int, latent_size: int, dim_conv: int, dim_hidden: int,
                 dim_out: int, n_layers: int, kernel_size: int, stride: int):
        super().__init__()
        self.dim_hidden = dim_hidden
        self.mlc = MultiLayerConv(in_channels, dim_conv, n_layers, kernel_size, stride)
        self.mlp = dense(dim_conv, dim_hidden)
        self.lstm = LSTMCell(dim_hidden + latent_size, dim_hidden)
        self.mean_update = dense(dim_hidden, dim_out)
        self.logsig_update = dense(dim_hidden, dim_out)

    def forward(self, x: torch.Tensor, latent: torch.Tensor, state):
        """x [B, K, H, W, D], latent [B, K, 4L], state (c, h) [B*K, hidden]."""
        B, K = x.shape[:2]
        x = self.mlc(x.reshape((B * K,) + x.shape[2:]).permute(0, 3, 1, 2))
        x = F.elu(self.mlp(x.mean(dim=(2, 3))))
        state, h = self.lstm(state, torch.cat([x, latent.reshape(B * K, -1)], dim=-1))
        return (self.mean_update(h).reshape(B, K, -1),
                self.logsig_update(h).reshape(B, K, -1), state)


def _kl_std_normal(mean: torch.Tensor, log_sigma: torch.Tensor) -> torch.Tensor:
    return 0.5 * (mean ** 2 + torch.exp(2 * log_sigma) - 1.0) - log_sigma


def _gaussian_log_prob(value: torch.Tensor, mean: torch.Tensor, sigma: float) -> torch.Tensor:
    var = sigma ** 2
    return -0.5 * (((value - mean) ** 2) / var + math.log(var) + math.log(2 * math.pi))


def layernorm_stat(x: torch.Tensor) -> torch.Tensor:
    """Per-slot standardisation (ocrl_tpu/models/iodine.py:144-153): over L
    with the sample std (ddof 1) for [B, K, L], over H, W, C with the
    population std for [B, K, H, W, C]; then / (std + 1e-5)."""
    if x.dim() == 3:
        mu = x.mean(dim=2, keepdim=True)
        std = x.std(dim=2, keepdim=True, correction=1)
    else:
        mu = x.mean(dim=(2, 3, 4), keepdim=True)
        std = torch.sqrt(((x - mu) ** 2).mean(dim=(2, 3, 4), keepdim=True))
    return (x - mu) / (std + 1e-5)


class Iodine_Module(nn.Module):
    noise_batch_axis = 1
    # its forward takes gradients of its own (the refinement's), which
    # torch.func's vmap cannot run: a multi-seed policy calls it seed by seed
    vmappable = False

    def __init__(self, ocr_config: IodineConfig, env_config: EnvConfig):
        super().__init__()
        ocr = ocr_config
        self.slot_size, self.num_slots = ocr.slot_size, ocr.num_slots
        self.num_iterations = ocr.num_iterations
        self.img_size = env_config.obs_size
        self.beta, self.sigma, self.use_layernorm = ocr.beta, ocr.sigma, ocr.layer_norm
        self.refine = RefinementNetwork(
            17, 4 * ocr.slot_size, ocr.ref_cnn_hidden_size, ocr.ref_mlp_hidden_size,
            ocr.slot_size, ocr.ref_cnn_layers, ocr.ref_cnn_kernel_size,
            ocr.ref_cnn_stride_size)
        self.decoder = Decoder(ocr.slot_size, ocr.dec_cnn_hidden_size, ocr.dec_cnn_layers,
                               ocr.dec_cnn_kernel_size, self.img_size)
        self.slot_mean_init = nn.Parameter(torch.zeros(1, 1, ocr.slot_size))
        self.slot_logsig_init = nn.Parameter(torch.zeros(1, 1, ocr.slot_size))

    def _ln(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm_stat(x) if self.use_layernorm else x

    def _elbo(self, image, means, logsigs, recons, masks):
        """(ELBO, pixel log-likelihood [B, 1, H, W, 3], component log
        densities [B, K, H, W, 3]); image [B, 1, H, W, 3]."""
        B = image.shape[0]
        kl = _kl_std_normal(means, logsigs).sum() / B
        comp_lp = _gaussian_log_prob(image, recons, self.sigma)
        pixel_ll = torch.logsumexp(torch.log(masks + 1e-12) + comp_lp, dim=1, keepdim=True)
        return pixel_ll.sum() / B - self.beta * kl, pixel_ll, comp_lp

    def _encoding(self, image, recons, masks, mask_logits, comp_lp, pixel_ll, g_recons,
                  g_masks) -> torch.Tensor:
        """The refinement network's 17 input maps [B, K, H, W, 17]
        (ocrl_tpu/models/iodine.py:219-245)."""
        B, K, H, W, _ = recons.shape
        comp_sum = comp_lp.sum(-1, keepdim=True)
        a_ll = torch.exp(pixel_ll.sum(-1, keepdim=True)).expand(B, K, H, W, 1)
        comp_probs = torch.exp(comp_sum)
        weighted = (masks * comp_probs).sum(1, keepdim=True)
        loo = (weighted - masks * comp_probs) / (1 - masks + 1e-5)
        coords = self.decoder.coords[0].permute(1, 2, 0).expand(B, K, H, W, 2)
        return torch.cat([image.expand(B, K, H, W, 3), recons, masks, mask_logits,
                          torch.log_softmax(comp_sum, dim=1), self._ln(g_recons),
                          self._ln(g_masks), self._ln(a_ll).detach(), self._ln(loo).detach(),
                          coords], dim=-1)

    def _refine(self, image, means, logsigs, state, eps, outer: bool):
        """One iteration: the draw, its decoding and ELBO, the four inner
        gradients and the refinement. Returns (slots, recons, masks, ELBO,
        the refined means and log sigmas, the LSTM state). Where the caller
        records no graph, the posterior enters as detached leaves; where it
        does, it always requires grad, so the outer graph runs through
        every iteration."""
        B = image.shape[0]
        if not (outer and means.requires_grad and logsigs.requires_grad):
            means, logsigs = means.detach().requires_grad_(), logsigs.detach().requires_grad_()
        slots = means + torch.exp(logsigs) * eps
        recons, mask_logits = self.decoder(slots)
        masks = torch.softmax(mask_logits, dim=1)
        elbo, pixel_ll, comp_lp = self._elbo(image, means, logsigs, recons, masks)
        g_means, g_logsigs, g_recons, g_masks = torch.autograd.grad(
            B * elbo, (means, logsigs, recons, masks), retain_graph=outer)
        with torch.set_grad_enabled(outer):
            latent = torch.cat([means, logsigs, self._ln(g_means), self._ln(g_logsigs)], dim=-1)
            encoding = self._encoding(image, recons, masks, mask_logits, comp_lp, pixel_ll,
                                      g_recons, g_masks)
            mean_delta, logsig_delta, state = self.refine(encoding, latent, state)
            return (slots, recons, masks, elbo, means + mean_delta, logsigs + logsig_delta,
                    state)

    def _initial(self, image: torch.Tensor):
        B, K, L = image.shape[0], self.num_slots, self.slot_size
        return (self.slot_mean_init.expand(B, K, L), self.slot_logsig_init.expand(B, K, L),
                (image.new_zeros(B * K, self.refine.dim_hidden),) * 2)

    def _iterations(self, image: torch.Tensor, eps: torch.Tensor, outer: bool,
                    with_masks: bool):
        """The representation's loop: (the last iteration's slots, and its
        masks with ``with_masks``). That iteration's refinement feeds only
        the loss, so it stops at the draw."""
        means, logsigs, state = self._initial(image)
        image = image[:, None]
        for it in range(self.num_iterations - 1):
            *_, means, logsigs, state = self._refine(image, means, logsigs, state, eps[it],
                                                     outer)
        with torch.set_grad_enabled(outer):
            slots = means + torch.exp(logsigs) * eps[-1]
            masks = torch.softmax(self.decoder(slots)[1], dim=1) if with_masks else None
        return slots, masks

    def _all_iterations(self, image: torch.Tensor, eps: torch.Tensor, outer: bool):
        """The loss's loop (iodine.py:253-302): every iteration with its
        refinement. Returns the last iteration's slots, decoded RGB and
        masks, every iteration's ELBO [N], and the posterior after the last
        refinement (means, log sigmas), on which the reported KL is taken."""
        means, logsigs, state = self._initial(image)
        image = image[:, None]
        elbos = []
        for it in range(self.num_iterations):
            slots, recons, masks, elbo, means, logsigs, state = self._refine(
                image, means, logsigs, state, eps[it], outer)
            elbos.append(elbo)
        return slots, recons, masks, torch.stack(elbos), means, logsigs

    def _with_autograd(self, obs: torch.Tensor, eps: torch.Tensor | None,
                       generator: torch.Generator | None, loop, *args):
        """``loop(image, eps, outer, *args)`` with autograd open, whatever
        the caller's mode; ``eps`` drawn from ``generator`` when None. Its
        tensors come back detached where the caller records no graph."""
        outer = torch.is_grad_enabled() and not torch.is_inference_mode_enabled()
        with torch.inference_mode(False), torch.enable_grad():
            # an inference tensor cannot be saved for backward: copy it out
            image = obs.clone() if obs.is_inference() else obs
            if eps is None:
                eps = self._draw(obs.shape[0], generator, obs.device)
            elif eps.is_inference():
                eps = eps.clone()
            out = loop(image, eps, outer, *args)
        if not outer:
            out = tuple(None if t is None else t.detach() for t in out)
        return out

    def noise_shape(self, B: int) -> tuple[int, ...]:
        """The shape of ``forward``'s ``noise`` for B observations."""
        return (self.num_iterations, B, self.num_slots, self.slot_size)

    def _draw(self, B: int, generator: torch.Generator | None, device) -> torch.Tensor:
        return torch.randn(self.noise_shape(B), generator=generator, device=device)

    def forward(self, obs: torch.Tensor, noise: torch.Tensor | None = None,
                generator: torch.Generator | None = None, with_masks: bool = False):
        """obs [B, H, W, C] in [0, 1] -> slots [B, K, L] (and the last
        iteration's masks [B, K, H, W, 1] with ``with_masks``). ``noise``
        [num_iterations, B, K, L] is the draws' eps; without it they come
        from ``generator``."""
        slots, masks = self._with_autograd(obs, noise, generator, self._iterations, with_masks)
        return (slots, masks) if with_masks else slots

    def _full(self, obs: torch.Tensor, generator, noise: dict | None):
        eps = given_or_drawn(noise, "eps", lambda: self._draw(obs.shape[0], generator,
                                                              obs.device))
        return self._with_autograd(obs, eps, generator, self._all_iterations)

    def loss(self, obs: torch.Tensor, masks: torch.Tensor | None = None, step: int = 0,
             train: bool = False, *, generator: torch.Generator | None = None,
             noise: dict | None = None):
        """(loss, metrics) of obs [B, H, W, C] in [0, 1] (iodine.py:290-320):
        the loss is -sum_i (i + 1) / N ELBO_i; ``mse`` is the last
        iteration's summed squared error over B, unclipped; ``kld`` the KL
        of the posterior after the last refinement over B; with masks
        [B, K', H, W, 1] (background last) the foreground ``ari`` of the
        last masks, concat([masks * fg, fg]) as JAX builds it. ``step`` and
        ``train`` are unused."""
        B = obs.shape[0]
        _, recons, attns, elbos, means, logsigs = self._full(obs, generator, noise)
        N = self.num_iterations
        weights = torch.arange(1, N + 1, dtype=torch.float32, device=obs.device) / N
        loss = -(weights * elbos).sum()
        metrics = {"loss": loss,
                   "mse": ((obs - (attns * recons).sum(1)) ** 2).sum() / B,
                   "kld": _kl_std_normal(means, logsigs).sum() / B}
        if masks is not None:
            fg = 1.0 - masks[:, -1:]
            metrics["ari"] = calculate_ari(masks, torch.cat([attns * fg, fg], dim=1)).mean()
        return loss, metrics

    @torch.no_grad()
    def sample_arrays(self, obs: torch.Tensor, generator: torch.Generator | None = None,
                      noise: dict | None = None):
        """(obs, the mixture's image, each slot's masked RGB, its mask as
        RGB, its RGB) (iodine.py:322-326), clipped to [0, 1]."""
        _, recons, masks, *_ = self._full(obs, generator, noise)
        clipped = recons.clamp(0.0, 1.0)
        return (obs, (masks * recons).sum(1).clamp(0.0, 1.0),
                (clipped * masks).clamp(0.0, 1.0), masks.expand(-1, -1, -1, -1, 3), clipped)

    @staticmethod
    def samples_grid(obs, recon, masked, masks3, recons) -> dict:
        """Every array side by side along the width, uint8."""
        return {"samples": for_viz(visualize([obs, recon, masked, masks3, recons]))}


def dims(ocr_config: IodineConfig, env_config: EnvConfig) -> tuple[int, int]:
    return ocr_config.slot_size, ocr_config.num_slots
