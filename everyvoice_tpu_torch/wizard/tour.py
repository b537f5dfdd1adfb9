"""The wizard's engine (counterpart of everyvoice_tpu/wizard/tour.py): a
tree of reversible question steps, each with prompt, sanitize, validate,
effect and undo; a ``Tour`` that walks them depth first, with the Ctrl-C
menu (go back a step, continue, view progress, save and exit, exit); and
sessions saved and resumed as YAML lists of [name, response] pairs, written
with ``utils/yaml_lite.py``, that either package's wizard reads.

Prompts go through an injectable ``ask`` callable, so a test scripts the
answers; ``interactive_ask`` reads them from standard input, so a process
can drive the wizard through a pipe.
"""

from __future__ import annotations

import copy
import logging
from pathlib import Path
from typing import Any, Callable, List, Optional

logger = logging.getLogger(__name__)

MAX_VALIDATION_FAILURES = 20


class StepError(Exception):
    pass


class Step:
    """One question: prompt → sanitize → validate → effect (undoable)."""

    DEFAULT_NAME = "step"
    # Whether "go back a step" may undo this once completed.
    reversible = True

    def __init__(
        self,
        name: Optional[str] = None,
        prompt_text: str = "",
        default: Any = None,
        parent: Optional["Step"] = None,
    ):
        self.name = name or self.DEFAULT_NAME
        self.prompt_text = prompt_text
        self.default = default
        self.response: Any = None
        self.completed = False
        self.children: List[Step] = []
        self.parent = parent
        if parent is not None:
            parent.children.append(self)
        self.state: dict = {}
        self.tour: Optional["Tour"] = None
        self._inserted: List[Step] = []
        self._state_snapshot: Optional[dict] = None

    # -- overridables -----------------------------------------------------
    def prompt(self) -> Any:
        assert self.tour is not None
        return self.tour.ask(self.prompt_text, default=self.default, step=self)

    def sanitize_input(self, response: Any) -> Any:
        return response

    def validate(self, response: Any) -> bool:
        return True

    def effect(self) -> None:
        """Runs after a valid response is recorded."""

    def undo(self) -> None:
        """Reverse this step: restore the shared state snapshot taken just
        before `effect`, remove any steps the effect inserted, and mark the
        step incomplete so it re-prompts."""
        for inserted in self._inserted:
            parent = inserted.parent
            if parent is not None and inserted in parent.children:
                parent.children.remove(inserted)
        self._inserted = []
        if self._state_snapshot is not None:
            self.state.clear()
            self.state.update(self._state_snapshot)
            self._state_snapshot = None
        self.response = None
        self.completed = False

    def looks_like_choice(self) -> Optional[list]:
        """Return a list of choices if this is a menu step."""
        return None

    # -- mechanics ----------------------------------------------------------
    def run(self) -> None:
        assert self.tour is not None
        failures = 0
        while True:
            raw = self.prompt()
            response = self.sanitize_input(raw)
            if self.validate(response):
                self.response = response
                self.completed = True
                self.tour.record(self)
                self._state_snapshot = copy.deepcopy(dict(self.state))
                self.tour._effect_owner = self
                try:
                    self.effect()
                finally:
                    self.tour._effect_owner = None
                return
            failures += 1
            logger.warning(f"Invalid response for {self.name}: {raw!r}")
            if failures >= MAX_VALIDATION_FAILURES:
                raise StepError(
                    f"Step {self.name} failed validation "
                    f"{MAX_VALIDATION_FAILURES} times; aborting."
                )

    def descendants(self) -> list:
        out = []
        for child in self.children:
            out.append(child)
            out.extend(child.descendants())
        return out


class RootStep(Step):
    DEFAULT_NAME = "Root"

    def run(self) -> None:
        self.completed = True


class _InterruptMenu(Step):
    """Synthetic menu shown on Ctrl-C; not recorded, not replayed."""

    DEFAULT_NAME = "keyboard-interrupt-menu"
    is_menu = True
    CHOICES = [
        "go back a step",
        "continue",
        "view progress",
        "save and exit",
        "exit",
    ]

    def looks_like_choice(self) -> Optional[list]:
        return list(self.CHOICES)


def interactive_ask(prompt_text: str, default=None, step: Optional[Step] = None):
    choices = step.looks_like_choice() if step is not None else None
    if choices:
        print(prompt_text)
        for i, choice in enumerate(choices):
            print(f"  [{i}] {choice}")
        while True:
            raw = input(f"Choose 0-{len(choices) - 1}: ").strip()
            if raw == "" and default is not None:
                return default
            try:
                return choices[int(raw)]
            except (ValueError, IndexError):
                print("Please enter a valid number.")
    suffix = f" [{default}]" if default not in (None, "") else ""
    raw = input(f"{prompt_text}{suffix}: ")
    if raw == "" and default is not None:
        return default
    return raw


class Tour:
    def __init__(
        self,
        name: str,
        steps: List[Step],
        state: Optional[dict] = None,
        ask: Callable = interactive_ask,
        trace: bool = False,
        debug_state: bool = False,
    ):
        self.name = name
        self.state = state if state is not None else {}
        self.ask = ask
        # new-project's hidden --trace / --debug-state: print each visited
        # step's answer, and the state before each step.
        self.trace_mode = trace
        self.debug_state = debug_state
        self.trace: list = []  # [(name, response)] for save/resume
        self.history: List[Step] = []  # completed steps, for "back"
        self.root = RootStep()
        self.root.tour = self
        self.root.state = self.state
        self._effect_owner: Optional[Step] = None
        for step in steps:
            self.add_step(step)

    def add_step(self, step: Step, parent: Optional[Step] = None) -> None:
        parent = parent or self.root
        step.parent = parent
        if step not in parent.children:
            parent.children.append(step)
        self._adopt(step)

    def add_steps_right_after(self, steps: List[Step], after: Step) -> None:
        """Insert steps as the next siblings of `after` (used by dataset
        subtours and the 'more datasets' loop)."""
        parent = after.parent or self.root
        idx = parent.children.index(after) + 1
        for offset, step in enumerate(steps):
            step.parent = parent
            parent.children.insert(idx + offset, step)
            self._adopt(step)
        if self._effect_owner is not None:
            self._effect_owner._inserted.extend(steps)

    def _adopt(self, step: Step) -> None:
        step.tour = self
        step.state = self.state
        for child in step.descendants():
            child.tour = self
            child.state = self.state

    def record(self, step: Step) -> None:
        self.trace.append([step.name, step.response])

    # -- persistence --------------------------------------------------------
    def save_progress(self, path: Path | str) -> None:
        from everyvoice_tpu_torch.utils import yaml_lite

        data = {"tour": self.name, "version": "1.0", "responses": self.trace}
        Path(path).write_text(yaml_lite.dump(data), encoding="utf8")

    @staticmethod
    def load_progress(path: Path | str) -> list:
        from everyvoice_tpu_torch.utils import yaml_lite

        data = yaml_lite.load(Path(path).read_text(encoding="utf8"))
        if not isinstance(data, dict) or "responses" not in data:
            raise StepError(f"{path} is not a saved wizard session")
        version = str(data.get("version", "1.0"))
        if version.split(".")[0] != "1":
            raise StepError(
                f"{path} was saved by an incompatible wizard version "
                f"({version}); this wizard reads version 1.x sessions."
            )
        return data["responses"]

    # -- traversal ------------------------------------------------------------
    def _next_step(self) -> Optional[Step]:
        """First incomplete step in depth-first pre-order (children may have
        been inserted dynamically since the last visit)."""

        def walk(node: Step) -> Optional[Step]:
            if not node.completed:
                return node
            for child in node.children:
                found = walk(child)
                if found is not None:
                    return found
            return None

        return walk(self.root)

    def run(self, resume_from: Optional[Path] = None) -> dict:
        scripted: list = []
        if resume_from is not None:
            scripted = self.load_progress(resume_from)
        replay = {i: resp for i, (_, resp) in enumerate(scripted)}
        count = 0
        original_ask = self.ask

        def replaying_ask(prompt_text, default=None, step=None):
            nonlocal count
            if getattr(step, "is_menu", False):
                # Menu prompts are not steps: never replayed, never counted.
                return original_ask(prompt_text, default=default, step=step)
            if count in replay:
                response = replay[count]
                count += 1
                return response
            count += 1
            return original_ask(prompt_text, default=default, step=step)

        self.ask = replaying_ask
        try:
            self.root.run()
            while True:
                step = self._next_step()
                if step is None:
                    break
                if self.debug_state:
                    print(f"[wizard state before {step.name}] {self.state}")
                try:
                    step.run()
                    self.history.append(step)
                    if self.trace_mode:
                        print(f"{step.name}: {step.response!r}")
                except KeyboardInterrupt:
                    self.keyboard_interrupt_action()
        finally:
            self.ask = original_ask
        return self.state

    # -- Ctrl-C menu ---------------------------------------------------------
    def keyboard_interrupt_action(self) -> None:
        """The Ctrl-C menu: go back / continue / view progress / save and
        exit / exit."""
        menu = _InterruptMenu()
        menu.tour = self
        menu.state = self.state
        while True:
            try:
                choice = self.ask(
                    "What would you like to do?", default="continue", step=menu
                )
            except KeyboardInterrupt:
                raise SystemExit(1) from None
            if choice in ("continue", "", None):
                return
            if choice == "go back a step":
                self.go_back()
                return
            if choice == "view progress":
                for name, response in self.trace:
                    logger.info(f"  {name}: {response!r}")
                continue
            if choice == "save and exit":
                save_path = Path(f"{self.name.replace(' ', '-')}-progress.yaml")
                self.save_progress(save_path)
                logger.info(f"Progress saved to {save_path}")
                raise SystemExit(0)
            if choice == "exit":
                raise SystemExit(1)
            logger.warning(f"Unknown choice {choice!r}")

    def go_back(self) -> None:
        """Undo the most recent completed step so it re-prompts."""
        while self.history:
            last = self.history.pop()
            if not last.reversible:
                logger.warning(
                    f"Step {last.name} cannot be undone; staying put."
                )
                self.history.append(last)
                return
            if self.trace and self.trace[-1][0] == last.name:
                self.trace.pop()
            last.undo()
            return
        logger.info("Nothing to go back to.")
