"""The new-project wizard's tour (counterpart of
everyvoice_tpu/wizard/main_tour.py): the project's basics, one dataset's
subtour and the "more datasets" question, whose effect adds the next
dataset's subtour, or the out-of-domain and config-format steps when the
user is done."""

from __future__ import annotations

from everyvoice_tpu_torch.wizard.steps import (
    ContactEmailStep,
    ContactNameStep,
    MoreDatasetsStep,
    NameStep,
    OutputPathStep,
    get_dataset_steps,
)
from everyvoice_tpu_torch.wizard.tour import Tour, interactive_ask


def get_main_wizard_tour(
    ask=interactive_ask, trace: bool = False, debug_state: bool = False
) -> Tour:
    steps = [
        NameStep(),
        ContactNameStep(),
        ContactEmailStep(),
        OutputPathStep(),
        *get_dataset_steps(0),
        MoreDatasetsStep(),
    ]
    return Tour(
        "EveryVoice TPU new-project wizard",
        steps,
        ask=ask,
        trace=trace,
        debug_state=debug_state,
    )
