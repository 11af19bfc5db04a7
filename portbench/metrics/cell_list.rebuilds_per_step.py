"""Cell-list rebuilds per step over the window: the state's device counter
``SimulationState.rebuilds`` at the end of each pass, over the steps."""


def read(obs):
    return obs["rebuilds"] / obs["steps"] if obs["steps"] else None
