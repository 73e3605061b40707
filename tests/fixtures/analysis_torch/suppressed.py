"""Suppression semantics: trailing and standalone forms silence a
named rule; bare or unknown ``disable`` is itself a finding and the
underlying hazard stays live."""

import torch
import numpy as np


def accepted_one_shot(x):
    return torch.compile(lambda v: v + 1)(x)  # torchlint: disable=rebuild-hazard — fixture: accepted one-shot


def _dispatch_chunk(engine):
    # torchlint: disable=host-sync-in-dispatch — fixture: standalone
    # form, justification continuing over a second comment line
    return engine.pos.cpu()


def bare_disable(x):
    return torch.compile(lambda v: v)(x)  # torchlint: disable   (EXPECT: bad-suppression, rebuild-hazard)


def unknown_rule(x):
    return torch.compile(lambda v: v - 1)(x)  # torchlint: disable=no-such-rule  (EXPECT: bad-suppression, rebuild-hazard)
